"""StableDiff U-Net configs, the paper's own targets (Sec. VI-A).

Same values as ``repro/configs/stablediff.py``:

* sd_v14 / sd_v21: latent 64x64 (512x512 images), 860M-class U-Net;
* sd_xl: latent 128x128, 3 levels, tf_depth=2 (structural approximation);
* sdxl_base: Stable Diffusion XL base 1.0 at its published widths (the
  port's own; the JAX package has none): transformer stacks of depth
  1 / 2 / 10 by level, 64-wide heads and the "text_time" conditioning;
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

#: stabilityai/stable-diffusion-xl-base-1.0 ``unet/config.json``: no
#: attention at level 0, stacks of 2 and 10 blocks at levels 1 and 2 (and
#: 10 in the mid block), 10 and 20 heads of 64, context 2048 x 77, a pooled
#: text vector of 1280 and 6 time ids through 256-wide sinusoids (2816 into
#: the MLP); 2,567,463,684 parameters published, 915,200 fewer here (no
#: bias on the attention out-projections and the feed-forward)
SDXL_BASE = UNetConfig(
    name="sdxl_base",
    base_channels=320,
    channel_mult=(1, 2, 4),
    n_res_blocks=2,
    attn_levels=(1, 2),
    n_heads=10,  # unused: head_dim sets the heads by level
    tf_depth=1,  # unused: tf_depths sets the depths
    tf_depths=(1, 2, 10),
    head_dim=64,
    ctx_dim=2048,
    ctx_len=77,
    time_dim=1280,
    latent_size=128,
    pooled_dim=1280,
    n_time_ids=6,
    time_id_dim=256,
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
