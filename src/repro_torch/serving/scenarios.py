"""Deterministic conditioned-pipeline scenarios.

Port of ``repro/serving/scenarios.py``: one canonical request stream that
covers every conditioned task the engine runs (img2img at a truncating and
an almost-full strength, inpainting with a full-ones mask, which is the
txt2img identity, and a half mask, and a K=3 variation group sharing one
prompt) on the ``sd_toy`` U-Net, with two runners: the continuous engine
and the straight-line :func:`repro_torch.core.sampler.pas_denoise`
reference.  The weights are passed in.

The constants are the JAX package's (``repro/serving/golden.py`` and
``scenarios.py``), so both packages build the same stream array for array.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.configs import get_unet_config
from repro_torch.core import sampler as SM
from repro_torch.models import diffusion as D
from repro_torch.models import unet as U
from repro_torch.serving.engine import (
    DiffusionEngine,
    EngineConfig,
    GenRequest,
    resolve_kernels,
)

UCFG = get_unet_config("sd_toy")
N_UP = U.n_up_steps(UCFG)
L_SKETCH, L_REFINE = min(3, N_UP), min(2, N_UP)
DCFG = DiffusionConfig(timesteps_sample=6)
N_LANES = 2
MAX_STEPS = 8
_REQ_SEED = 4321

#: base (untruncated) schedule length every scenario is cut from
BASE_T = DCFG.timesteps_sample

#: the two img2img strengths (truncated / nearly full)
STRENGTHS = (0.4, 0.75)

#: variation fan-out width
N_VARIANTS = 3


def _n_exec(strength: float) -> int:
    """The executed step count ``strength`` resolves to."""
    return max(1, round(strength * BASE_T))


def _plan(timesteps: int) -> PASPlan:
    return PASPlan(
        t_sketch=max(2, timesteps // 2 + 1),
        t_complete=2,
        t_sparse=2,
        l_sketch=L_SKETCH,
        l_refine=L_REFINE,
    )


def _half_mask(length: int) -> np.ndarray:
    """First half kept from the init latent, second half generated."""
    m = np.ones((length, 1), np.float32)
    m[: length // 2] = 0.0
    return m


def scenario_requests() -> list[tuple[str, GenRequest]]:
    """The named scenario stream -> [(name, request)]; rids follow list
    order, and the three ``var_*`` requests share one prompt."""
    latent = (UCFG.latent_size**2, UCFG.in_channels)
    out: list[tuple[str, GenRequest]] = []

    def draw(rng):
        ctx = rng.normal(size=(UCFG.ctx_len, UCFG.ctx_dim)).astype(np.float32) * 0.2
        noise = rng.normal(size=latent).astype(np.float32)
        return ctx, noise

    # img2img: 0.4 truncates hard (all-FULL: too short for a PAS plan),
    # 0.75 keeps a PAS plan
    for i, strength in enumerate(STRENGTHS):
        rng = np.random.default_rng(_REQ_SEED + i)
        ctx, noise = draw(rng)
        init = rng.normal(size=latent).astype(np.float32)
        n_exec = _n_exec(strength)
        out.append((
            f"img2img_s{int(round(strength * 100)):03d}",
            GenRequest(
                rid=len(out), ctx=ctx, noise=noise,
                timesteps=n_exec, base_timesteps=BASE_T,
                plan=_plan(n_exec) if n_exec >= 4 else None,
                init_latent=init,
            ),
        ))

    # inpainting: full-ones mask (the txt2img identity) and half mask
    for name, mask in (
        ("inpaint_ones", np.ones((latent[0], 1), np.float32)),
        ("inpaint_half", _half_mask(latent[0])),
    ):
        rng = np.random.default_rng(_REQ_SEED + 10 + len(out))
        ctx, noise = draw(rng)
        init = rng.normal(size=latent).astype(np.float32)
        out.append((
            name,
            GenRequest(
                rid=len(out), ctx=ctx, noise=noise,
                timesteps=BASE_T,
                plan=_plan(BASE_T) if name == "inpaint_half" else None,
                init_latent=init, mask=mask,
            ),
        ))

    # K=3 variation group: one prompt, per-variant noise
    rng = np.random.default_rng(_REQ_SEED + 100)
    ctx, noise = draw(rng)
    noises = [noise] + [rng.normal(size=latent).astype(np.float32)
                        for _ in range(N_VARIANTS - 1)]
    for v, n in enumerate(noises):
        out.append((
            f"var_{v}",
            GenRequest(rid=len(out), ctx=ctx, noise=n, timesteps=BASE_T, plan=_plan(BASE_T)),
        ))
    return out


def run_engine(
    params: dict[str, Any],
    *,
    cache_mode: str = "off",
    cache_threshold: float = 0.0,
    device: str = "cuda",
    backend: str | None = None,
) -> dict[str, np.ndarray]:
    """Serve the scenario stream through the continuous engine -> {name: latent}."""
    cfg = EngineConfig(
        n_lanes=N_LANES, max_steps=MAX_STEPS, l_sketch=L_SKETCH, l_refine=L_REFINE,
        decode_images=False, cache_mode=cache_mode, cache_threshold=cache_threshold,
        device=device, backend=backend,
    )
    engine = DiffusionEngine(UCFG, DCFG, params, None, cfg)
    named = scenario_requests()
    done, _ = engine.run([req for _, req in named])
    by_rid = {d.rid: d.latent for d in done}
    return {name: by_rid[req.rid] for name, req in named}


def run_straight_line(
    params: dict[str, Any], *, device: str = "cuda", backend: str | None = None
) -> dict[str, np.ndarray]:
    """Each scenario alone through ``pas_denoise`` -> {name: latent},
    conditioned as the engine conditions it: the truncated schedule, the
    q_sampled img2img entry at ``ts[0]``, and the per-step inpaint blend
    with the request's own noise as the known-region noise."""
    sched = D.make_schedule(DCFG, device)
    zeros_ctx = torch.zeros((1, UCFG.ctx_len, UCFG.ctx_dim), device=device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)[None]  # noqa: E731
    kernels = resolve_kernels(device, backend)
    out = {}
    for name, req in scenario_requests():
        base = req.timesteps if req.base_timesteps is None else req.base_timesteps
        ts = SM.truncated_timesteps(DCFG, base, req.timesteps)
        noise = as_t(req.noise)
        if req.init_latent is not None and req.timesteps < base:
            t0 = torch.full((1,), int(ts[0]), device=device)
            x_t = D.q_sample(sched, as_t(req.init_latent), t0, noise)
        else:
            x_t = noise
        mask = x_init = noise0 = None
        if req.mask is not None:
            mask, x_init, noise0 = as_t(req.mask).reshape(1, -1, 1), as_t(req.init_latent), noise
        x0 = SM.pas_denoise(
            UCFG, DCFG, params, req.plan, x_t, as_t(req.ctx), zeros_ctx,
            ts=ts, mask=mask, x_init=x_init, noise0=noise0, backend=kernels,
        )
        out[name] = x0[0].cpu().numpy()
    return out
