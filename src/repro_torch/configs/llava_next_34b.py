"""llava-next-34b [vlm] — anyres tiling VLM over a Yi-34B-class backbone.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  The vision tower +
anyres tile packer is a stub: ``input_specs`` supplies precomputed patch
embeddings concatenated with text embeddings.
"""
from repro_torch.common.types import GLOBAL, LMConfig

FULL = LMConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    pattern=(GLOBAL,),
    rope_theta=5_000_000.0,
    frontend_stub="vision_patches",
)

SMOKE = LMConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=128,
    pattern=(GLOBAL,),
    frontend_stub="vision_patches",
    dtype="float32",
)
