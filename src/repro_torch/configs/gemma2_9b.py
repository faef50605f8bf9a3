"""gemma2-9b [dense] — local+global alternating attention, logit softcap.

42L d_model=3584 16H (GQA kv=8, head_dim 256) d_ff=14336 vocab=256000
[arXiv:2408.00118; hf].  4096-token sliding window on local layers,
pre+post sublayer RMSNorm, soft caps on attention (50) and final logits
(30), GeGLU, tied embeddings with sqrt(d) input scaling.
"""
from repro_torch.common.types import GLOBAL, LMConfig, local

FULL = LMConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    pattern=(local(4096), GLOBAL),
    act="gelu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
)

SMOKE = LMConfig(
    name="gemma2-9b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=128,
    pattern=(local(8), GLOBAL),
    act="gelu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
    dtype="float32",
)
