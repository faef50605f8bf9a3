"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified].
"""
from repro_torch.common.types import GLOBAL, LMConfig

FULL = LMConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
    pattern=(GLOBAL,),
)

SMOKE = LMConfig(
    name="phi3-medium-14b-smoke",
    family="dense",
    n_layers=2,
    d_model=80,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=128,
    pattern=(GLOBAL,),
    dtype="float32",
)
