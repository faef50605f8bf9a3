"""StableDiff U-Net configs, the paper's own targets (Sec. VI-A).

Same values as ``repro/configs/stablediff.py``:

* sd_v14 / sd_v21: latent 64x64 (512x512 images), 860M-class U-Net;
* sd_xl: latent 128x128, 3 levels, tf_depth=2 (structural approximation);
* sd_100m: the ~100M member used by the training example;
* TOY: the CPU-sized member the parity tests run.
"""
from repro_torch.common.types import DiffusionConfig, UNetConfig

SD_V14 = UNetConfig(
    name="sd_v14",
    base_channels=320,
    channel_mult=(1, 2, 4, 4),
    n_res_blocks=2,
    attn_levels=(0, 1, 2),
    n_heads=8,
    tf_depth=1,
    ctx_dim=768,
    ctx_len=77,
    time_dim=1280,
    latent_size=64,
    dtype="bfloat16",
)

SD_V21 = UNetConfig(
    name="sd_v21",
    base_channels=320,
    channel_mult=(1, 2, 4, 4),
    n_res_blocks=2,
    attn_levels=(0, 1, 2),
    n_heads=10,
    tf_depth=1,
    ctx_dim=1024,
    ctx_len=77,
    time_dim=1280,
    latent_size=64,
    dtype="bfloat16",
)

SD_XL = UNetConfig(
    name="sd_xl",
    base_channels=320,
    channel_mult=(1, 2, 4),
    n_res_blocks=2,
    attn_levels=(1, 2),
    n_heads=10,
    tf_depth=2,
    ctx_dim=2048,
    ctx_len=77,
    time_dim=1280,
    latent_size=128,
    dtype="bfloat16",
)

SD_100M = UNetConfig(
    name="sd_100m",
    base_channels=128,
    channel_mult=(1, 2, 4),
    n_res_blocks=2,
    attn_levels=(0, 1, 2),
    n_heads=4,
    tf_depth=1,
    ctx_dim=128,
    ctx_len=16,
    time_dim=512,
    latent_size=32,
    dtype="float32",
)

TOY = UNetConfig(
    name="sd_toy",
    base_channels=32,
    channel_mult=(1, 2, 4),
    n_res_blocks=1,
    attn_levels=(0, 1),
    n_heads=2,
    tf_depth=1,
    ctx_dim=32,
    ctx_len=8,
    time_dim=128,
    groups=8,
    latent_size=16,
    dtype="float32",
)

DIFFUSION_50 = DiffusionConfig(timesteps_sample=50, scheduler="pndm", guidance_scale=7.5)
DIFFUSION_TOY = DiffusionConfig(timesteps_sample=25, scheduler="pndm", guidance_scale=3.0)
