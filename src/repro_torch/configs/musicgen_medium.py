"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub: ``input_specs``
supplies precomputed frame embeddings; 4 parallel codebook heads share the
backbone (delay-pattern bookkeeping lives in the frontend, not here).
Original uses sinusoidal positions added by the frontend -> use_rope=False.
"""
from repro_torch.common.types import GLOBAL, LMConfig

FULL = LMConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=(GLOBAL,),
    norm="layernorm",
    act="gelu",
    glu=False,
    use_rope=False,
    n_codebooks=4,
    frontend_stub="audio_frames",
)

SMOKE = LMConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=64,
    pattern=(GLOBAL,),
    norm="layernorm",
    act="gelu",
    glu=False,
    use_rope=False,
    n_codebooks=4,
    frontend_stub="audio_frames",
    dtype="float32",
)
