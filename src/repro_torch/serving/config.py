"""Typed engine construction: one path from config to serving stack.

Port of ``repro/serving/config.py``:

* :func:`from_args`: argparse namespace -> :class:`EngineConfig`;
* :func:`init_models`: config -> (ucfg, dcfg, params, vae_params), the one
  place served weights are made, from ``torch.Generator(seed)`` on the
  engine's device (random weights, as the JAX package serves);
* :func:`build_policy`: the process-wide quality resolver for an engine;
* :func:`build_engine`: config -> :class:`EngineBundle`.

Not ported yet: the sharded engine (``--shards``) and the HTTP front end.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.types import DiffusionConfig, UNetConfig
from repro_torch.configs import get_unet_config
from repro_torch.core.shift_score import load_profile
from repro_torch.models import unet as U
from repro_torch.models import vae as V
from repro_torch.serving.engine import DiffusionEngine, EngineConfig
from repro_torch.serving.policy import QualityPolicy
from repro_torch.serving.scheduler import (
    CacheAwareScheduler,
    FIFOScheduler,
    PlanAwareScheduler,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EngineBundle:
    engine: DiffusionEngine
    ucfg: UNetConfig
    dcfg: DiffusionConfig
    config: EngineConfig
    params: Params
    vae_params: Params | None
    policy: QualityPolicy


def from_args(args: Any, *, decode_images: bool = True) -> EngineConfig:
    """Map the ``repro_torch.launch.serve`` flags onto one :class:`EngineConfig`;
    missing attributes fall back to the engine defaults."""
    unet = getattr(args, "unet", "sd_toy")
    n_up = U.n_up_steps(get_unet_config(unet))
    return EngineConfig(
        n_lanes=args.batch,
        max_steps=args.timesteps,
        l_sketch=min(3, n_up),
        l_refine=min(2, n_up),
        decode_images=decode_images,
        cache_mode=getattr(args, "cache", "off"),
        cache_slots=getattr(args, "cache_slots", 16),
        cache_threshold=getattr(args, "cache_threshold", 0.15),
        cache_t_bucket=getattr(args, "cache_bucket", 125),
        cache_spill_mb=getattr(args, "cache_spill_mb", 0.0),
        backend=getattr(args, "kernels", None),
        device=getattr(args, "device", "cuda"),
        unet=unet,
        seed=getattr(args, "seed", 0),
        profile=getattr(args, "profile", None),
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


def build_policy(config: EngineConfig, ucfg: UNetConfig, dcfg: DiffusionConfig) -> QualityPolicy:
    """The quality resolver for an engine built from ``config``: its cache
    geometry plus the shift-score profile named by ``config.profile``."""
    profile = profile_ts = None
    if config.profile:
        profile, profile_ts = load_profile(config.profile)
    return QualityPolicy.for_engine(ucfg, dcfg, config, profile=profile, profile_ts=profile_ts)


def default_scheduler(config: EngineConfig) -> FIFOScheduler:
    """Cache-armed engines admit warm requests first; otherwise plan-aware."""
    if config.cache_mode != "off":
        return CacheAwareScheduler(window=config.window)
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
    return EngineBundle(
        engine, ucfg, dcfg, config, params, vae_params, build_policy(config, ucfg, dcfg)
    )
