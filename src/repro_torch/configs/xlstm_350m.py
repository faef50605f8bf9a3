"""xlstm-350m [ssm] — mLSTM-block recurrent LM.

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
mLSTM blocks throughout (no sLSTM blocks, a deviation); the
block's 2x up-projection plays the FFN role, hence d_ff=0.
"""
from repro_torch.common.types import GLOBAL, LMConfig

FULL = LMConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(GLOBAL,),
    ssm_expand=2,
)

SMOKE = LMConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=64,
    pattern=(GLOBAL,),
    ssm_expand=2,
    dtype="float32",
)
