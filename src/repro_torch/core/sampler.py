"""Phase-aware sampling executor (paper Sec. III-B, Fig. 5).

Port of ``repro/core/sampler.py``.  The JAX version is one ``lax.scan``
whose step picks a branch with ``lax.switch``; here the plan is known on the
host, so the loop is a Python loop and each step runs only its branch:

    FULL:   full U-Net, refresh the sketch/refine feature cache
    SKETCH: partial run with the top L_sketch blocks  (sketching phase)
    REFINE: partial run with the top L_refine blocks  (refinement phase)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.types import DiffusionConfig, PASPlan, UNetConfig
from repro_torch.models import diffusion as D
from repro_torch.models import unet as U

Params = dict[str, Any]

FULL, SKETCH, REFINE = 0, 1, 2


def plan_to_branches(plan: PASPlan, total_steps: int) -> list[int]:
    sched = plan.schedule(total_steps)
    br = [FULL if l < 0 else (SKETCH if l == plan.l_sketch else REFINE) for l in sched]
    # disambiguate when l_sketch == l_refine: phase decides the label
    for t in range(total_steps):
        if sched[t] >= 0 and t >= plan.t_sketch:
            br[t] = REFINE
    return br


def _entry_steps(ucfg: UNetConfig, plan: PASPlan) -> tuple[int, int]:
    n_up = U.n_up_steps(ucfg)
    return n_up - plan.l_sketch, n_up - plan.l_refine


def cfg_unet_step(
    ucfg: UNetConfig,
    params: Params,
    guidance: float,
    x: torch.Tensor,  # [B, L, C]
    t: torch.Tensor,  # scalar or [B] timesteps
    ctx2: torch.Tensor,  # [2B, ctx_len, ctx_dim] = [cond; uncond]
    *,
    entry_step: int = 0,
    entry_feat: torch.Tensor | None = None,  # [2B, ...] cached main-branch feature
    capture: tuple[int, ...] = (),
    backend=None,
) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
    """One classifier-free-guided U-Net call on the CFG-doubled batch.

    Returns the guided eps [B, L, C] and the captured main-branch features in
    the [2B, ...] cond/uncond-stacked layout.
    """
    b = x.shape[0]
    x2 = torch.cat([x, x], dim=0)
    tb = torch.as_tensor(t, device=x.device).expand(b)
    t2 = torch.cat([tb, tb], dim=0)
    eps2, cap = U.unet_apply(
        ucfg, params, x2, t2, ctx2,
        entry_step=entry_step, entry_feat=entry_feat, capture_steps=capture, backend=backend,
    )
    e_c, e_u = torch.chunk(eps2, 2, dim=0)
    return e_u + guidance * (e_c - e_u), cap


def feat_shape(ucfg: UNetConfig, entry_step: int, batch: int) -> tuple[int, ...]:
    """Shape of the main-branch feature entering ``entry_step``."""
    chans = [ucfg.base_channels * m for m in ucfg.channel_mult]
    plan = U._up_plan(ucfg)
    size = ucfg.latent_size >> plan[entry_step][0]
    c = chans[-1] if entry_step == 0 else chans[plan[entry_step - 1][0]]
    return (batch, size * size, c)


def pas_denoise(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params: Params,
    plan: PASPlan | None,
    x_t: torch.Tensor,  # [B, L, C] initial noise
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    *,
    backend=None,
) -> torch.Tensor:
    """Run the full PAS sampling loop (the straight-line reference).

    ``plan=None`` is the original sampler: every step is FULL.
    """
    sched = D.make_schedule(dcfg, x_t.device)
    ts = D.sample_timesteps(dcfg).tolist()
    total = dcfg.timesteps_sample
    t_prev = ts[1:] + [-1]
    guidance = dcfg.guidance_scale
    branches = [FULL] * total if plan is None else plan_to_branches(plan, total)
    e_sk, e_rf = (0, 0) if plan is None else _entry_steps(ucfg, plan)
    capture = () if plan is None else (e_sk, e_rf)
    ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)

    f_sk = torch.zeros(feat_shape(ucfg, e_sk, 2 * x_t.shape[0]), device=x_t.device)
    f_rf = torch.zeros(feat_shape(ucfg, e_rf, 2 * x_t.shape[0]), device=x_t.device)
    x = x_t
    pndm = D.pndm_init(x_t.shape, x_t.dtype, x_t.device)
    for t, tp, br in zip(ts, t_prev, branches):
        if br == FULL:
            eps, cap = cfg_unet_step(
                ucfg, params, guidance, x, t, ctx2, capture=capture, backend=backend
            )
            if plan is not None:
                f_sk, f_rf = cap[e_sk], cap[e_rf]
        else:
            entry, feat = (e_sk, f_sk) if br == SKETCH else (e_rf, f_rf)
            eps, _ = cfg_unet_step(
                ucfg, params, guidance, x, t, ctx2,
                entry_step=entry, entry_feat=feat, backend=backend,
            )
        if dcfg.scheduler == "pndm":
            x, pndm = D.pndm_step(sched, pndm, x, eps, t, tp)
        else:
            x = D.ddim_step(sched, x, eps, t, tp)
    return x
