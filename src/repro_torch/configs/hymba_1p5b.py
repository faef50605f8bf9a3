"""hymba-1.5b [hybrid] — parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 vocab=32001,
ssm_state=16 [arXiv:2411.13676; hf].  Sliding-window (1024) attention in
all layers (the 3 published full-attention layers are approximated as SWA
for uniform layer stacking).
"""
from repro_torch.common.types import GLOBAL, LMConfig

FULL = LMConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    pattern=(GLOBAL,),  # hybrid model: window handled inside the block
    ssm_state=16,
    ssm_expand=2,
)

SMOKE = LMConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=5,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=65,  # odd vocab like the original's 32001
    pattern=(GLOBAL,),
    ssm_state=8,
    ssm_expand=2,
    dtype="float32",
)
