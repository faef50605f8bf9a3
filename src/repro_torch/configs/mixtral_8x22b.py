"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) expert_ff=16384 vocab=32768
[arXiv:2401.04088; hf].  8 experts do not divide a 16-way model axis, so
experts shard in 'tp' mode (d_expert sliced over "model").
"""
from repro_torch.common.types import LMConfig, MoESpec, local

FULL = LMConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=32_768,
    pattern=(local(4096),),
    moe=MoESpec(num_experts=8, top_k=2, d_expert=16384, shard_mode="tp"),
)

SMOKE = LMConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=128,
    pattern=(local(8),),
    moe=MoESpec(num_experts=4, top_k=2, d_expert=96, shard_mode="tp"),
    dtype="float32",
)
