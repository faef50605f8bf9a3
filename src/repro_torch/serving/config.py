"""Typed engine construction: one path from config to serving stack.

Port of ``repro/serving/config.py``:

* :func:`from_args`: argparse namespace -> :class:`EngineConfig`;
* :func:`init_models`: config -> (ucfg, dcfg, params, vae_params), the one
  place served weights are made, from ``torch.Generator(seed)`` on the
  engine's device (random weights, as the JAX package serves);
* :func:`build_engine`: config -> :class:`EngineBundle`.

The quality policy and the shift-score profile are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.types import DiffusionConfig, UNetConfig
from repro_torch.configs import get_unet_config
from repro_torch.models import unet as U
from repro_torch.models import vae as V
from repro_torch.serving.engine import DiffusionEngine, EngineConfig
from repro_torch.serving.scheduler import FIFOScheduler, PlanAwareScheduler

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EngineBundle:
    engine: DiffusionEngine
    ucfg: UNetConfig
    dcfg: DiffusionConfig
    config: EngineConfig
    params: Params
    vae_params: Params | None


def from_args(args: Any, *, decode_images: bool = True) -> EngineConfig:
    """Map the ``repro_torch.launch.serve`` flags onto one :class:`EngineConfig`."""
    unet = getattr(args, "unet", "sd_toy")
    n_up = U.n_up_steps(get_unet_config(unet))
    return EngineConfig(
        n_lanes=args.batch,
        max_steps=args.timesteps,
        l_sketch=min(3, n_up),
        l_refine=min(2, n_up),
        decode_images=decode_images,
        backend=getattr(args, "kernels", None),
        device=getattr(args, "device", "cuda"),
        unet=unet,
        seed=getattr(args, "seed", 0),
        window=getattr(args, "window", 4),
    )


def init_models(
    config: EngineConfig,
) -> tuple[UNetConfig, DiffusionConfig, Params, Params | None]:
    """Config + freshly initialised U-Net/VAE weights on the engine's device."""
    device = config.torch_device()
    ucfg = get_unet_config(config.unet)
    dcfg = DiffusionConfig(timesteps_sample=config.max_steps)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    params = U.init_unet(ucfg, gen)
    vae_params = V.init_vae(gen, latent_channels=ucfg.in_channels) if config.decode_images else None
    return ucfg, dcfg, params, vae_params


def default_scheduler(config: EngineConfig) -> FIFOScheduler:
    return PlanAwareScheduler(window=config.window)


def build_engine(
    config: EngineConfig | None = None,
    *,
    scheduler: FIFOScheduler | None = None,
    models: tuple[UNetConfig, DiffusionConfig, Params, Params | None] | None = None,
) -> EngineBundle:
    """Config -> ready-to-serve bundle.  ``models`` (as :func:`init_models`
    returns them) injects fixed weights; by default they are made from
    ``(config.unet, config.seed)``."""
    config = EngineConfig() if config is None else config
    config.torch_device()  # no GPU and no explicit CPU: raise before any work
    ucfg, dcfg, params, vae_params = init_models(config) if models is None else models
    engine = DiffusionEngine(
        ucfg, dcfg, params, vae_params, config,
        scheduler=scheduler if scheduler is not None else default_scheduler(config),
    )
    return EngineBundle(engine, ucfg, dcfg, config, params, vae_params)
