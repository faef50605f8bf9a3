"""yi-6b [dense] — llama-arch GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652; hf].
"""
from repro_torch.common.types import GLOBAL, LMConfig

FULL = LMConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    pattern=(GLOBAL,),
    rope_theta=5_000_000.0,
)

SMOKE = LMConfig(
    name="yi-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=160,
    vocab_size=128,
    pattern=(GLOBAL,),
    rope_theta=5_000_000.0,
    dtype="float32",
)
