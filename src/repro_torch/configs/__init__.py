"""Config registry: ``--arch <id>`` and ``--unet <name>`` resolution for
launchers and tests (the port's copy of ``repro/configs/__init__.py``)."""
from __future__ import annotations

from repro_torch.common.types import LMConfig, SHAPE_CELLS, ShapeCell, UNetConfig
from repro_torch.configs import (
    gemma2_9b,
    gemma3_1b,
    hymba_1p5b,
    llava_next_34b,
    mixtral_8x22b,
    musicgen_medium,
    phi3_medium_14b,
    qwen3_moe_235b,
    stablediff,
    xlstm_350m,
    yi_6b,
)

_MODULES = {
    "musicgen-medium": musicgen_medium,
    "xlstm-350m": xlstm_350m,
    "yi-6b": yi_6b,
    "gemma2-9b": gemma2_9b,
    "phi3-medium-14b": phi3_medium_14b,
    "gemma3-1b": gemma3_1b,
    "hymba-1.5b": hymba_1p5b,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "llava-next-34b": llava_next_34b,
}

ARCH_IDS = tuple(_MODULES)

# long_500k applicability: sub-quadratic attention required -> run for
# SSM/hybrid/windowed archs only.
LONG_CONTEXT_OK = frozenset(
    {"xlstm-350m", "hymba-1.5b", "gemma3-1b", "gemma2-9b", "mixtral-8x22b"}
)

UNET_CONFIGS = {
    "sd_v14": stablediff.SD_V14,
    "sd_v21": stablediff.SD_V21,
    "sd_xl": stablediff.SD_XL,
    "sdxl_base": stablediff.SDXL_BASE,
    "sd_100m": stablediff.SD_100M,
    "sd_toy": stablediff.TOY,
}


def get_lm_config(arch: str, variant: str = "full") -> LMConfig:
    mod = _MODULES[arch]
    return mod.FULL if variant == "full" else mod.SMOKE


def get_unet_config(name: str) -> UNetConfig:
    return UNET_CONFIGS[name]


def cells_for(arch: str) -> list[ShapeCell]:
    """The assigned shape cells an arch actually runs (skips documented)."""
    out = []
    for cell in SHAPE_CELLS:
        if cell.name == "long_500k" and arch not in LONG_CONTEXT_OK:
            continue
        out.append(cell)
    return out
