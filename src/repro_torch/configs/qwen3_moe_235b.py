"""qwen3-moe-235b-a22b [moe] — 128 experts top-8.

94L d_model=4096 64H (GQA kv=4, head_dim 128) expert_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf].  QK-RMSNorm per head (qwen3 signature);
128 experts shard 8-per-chip over the 16-way model axis ('ep').
"""
from repro_torch.common.types import GLOBAL, LMConfig, MoESpec

FULL = LMConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    pattern=(GLOBAL,),
    qk_norm=True,
    # "tp" (d_expert over the model axis) matches the shard_map MoE
    # compute layout — EP storage would reshard 3x2.4GB of weights per
    # layer; a true all-to-all EP dispatch is the scoped next step.
    moe=MoESpec(num_experts=128, top_k=8, d_expert=1536, shard_mode="tp"),
)

SMOKE = LMConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=128,
    pattern=(GLOBAL,),
    qk_norm=True,
    moe=MoESpec(num_experts=8, top_k=4, d_expert=32, shard_mode="ep"),
    dtype="float32",
)
