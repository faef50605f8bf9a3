"""U-Net config registry (``--unet <name>`` resolution)."""
from __future__ import annotations

from repro_torch.common.types import UNetConfig
from repro_torch.configs import stablediff

UNET_CONFIGS = {
    "sd_v14": stablediff.SD_V14,
    "sd_v21": stablediff.SD_V21,
    "sd_xl": stablediff.SD_XL,
    "sd_100m": stablediff.SD_100M,
    "sd_toy": stablediff.TOY,
}


def get_unet_config(name: str) -> UNetConfig:
    return UNET_CONFIGS[name]
