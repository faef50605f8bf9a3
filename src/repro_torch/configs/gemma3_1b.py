"""gemma3-1b [dense] — 5:1 local:global attention, 128k-ready.

26L d_model=1152 4H (GQA kv=1, head_dim 256) d_ff=6912 vocab=262144
[hf:google/gemma-3-1b-pt; unverified].  Pattern = 5 x local(512) + 1 global
(26 layers = 4 full units + 2 local tail), per-head QK-RMSNorm, tied
embeddings, sqrt(d) input scaling.  Single RoPE theta (1M) is used for
both local and global layers (a deviation from the published model).
"""
from repro_torch.common.types import GLOBAL, LMConfig, local

FULL = LMConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    pattern=(local(512), local(512), local(512), local(512), local(512), GLOBAL),
    act="gelu",
    post_norm=True,
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="gemma3-1b-smoke",
    family="dense",
    n_layers=8,  # 1 full unit (5L+1G) + 2 local tail — exercises the tail path
    d_model=48,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=128,
    pattern=(local(8), local(8), local(8), local(8), local(8), GLOBAL),
    act="gelu",
    post_norm=True,
    qk_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    dtype="float32",
)
