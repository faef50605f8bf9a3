"""Phase-aware sampling executor (paper Sec. III-B, Fig. 5).

Port of ``repro/core/sampler.py``.  The JAX version is one ``lax.scan``
whose step picks a branch with ``lax.switch``; here the plan is known on the
host, so the loop is a Python loop and each step runs only its branch:

    FULL:   full U-Net, refresh the sketch/refine feature cache
    SKETCH: partial run with the top L_sketch blocks  (sketching phase)
    REFINE: partial run with the top L_refine blocks  (refinement phase)

:func:`denoise_with_capture` is the calibration path: all-FULL sampling that
copies the main-branch input of the given up-steps to host memory at every
step, for the shift scores of ``repro_torch.core.shift_score``.
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
    pooled2: torch.Tensor | None = None,  # [2B, pooled_dim] = [cond; uncond]
    time_ids2: torch.Tensor | None = None,  # [2B, n_time_ids]
) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
    """One classifier-free-guided U-Net call on the CFG-doubled batch (with
    the added conditioning's rows where the U-Net takes it).

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
        pooled=pooled2, time_ids=time_ids2,
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


def truncated_timesteps(dcfg: DiffusionConfig, base: int, n_exec: int) -> torch.Tensor:
    """The last ``n_exec`` timesteps of a ``base``-step sampling schedule.

    The img2img schedule: ``strength`` picks how many of the base schedule's
    final steps execute, while the stride (and so the train timestep each
    executed step sees) stays that of the untruncated schedule.
    ``n_exec == base`` is the stock schedule.
    """
    if not 1 <= n_exec <= base:
        raise ValueError(f"truncation wants {n_exec} of {base} steps")
    stride = dcfg.timesteps_train // base
    return (torch.arange(base) * stride).flip(0)[base - n_exec:]


def pas_denoise(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params: Params,
    plan: PASPlan | None,
    x_t: torch.Tensor,  # [B, L, C] entry latent (noise, or a q_sampled init)
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    *,
    ts=None,  # explicit descending timestep vector; None = the stock schedule
    mask: torch.Tensor | None = None,  # [B, L, 1] inpaint mask (1 = generate)
    x_init: torch.Tensor | None = None,  # [B, L, C] known latent under the mask
    noise0: torch.Tensor | None = None,  # [B, L, C] fixed noise for the known region
    backend=None,
) -> torch.Tensor:
    """Run the full PAS sampling loop: the straight-line reference the
    engine is held against.  ``plan=None`` is the original sampler: every
    step is FULL.  ``ts`` and the inpaint tensors serve the conditioned tasks:

    * img2img: the strength-truncated schedule of :func:`truncated_timesteps`
      and an entry latent seeded by ``q_sample`` at ``ts[0]``;
    * inpainting: ``mask`` / ``x_init`` / ``noise0``; after every scheduler
      step the masked-out region is replaced by the known latent re-noised
      to that step's target timestep (the clean ``x_init`` after the last).
      The blend keeps the denoised latent exactly where ``mask >= 1``.
    """
    sched = D.make_schedule(dcfg, x_t.device)
    ts = D.sample_timesteps(dcfg) if ts is None else ts
    ts = [int(t) for t in ts]
    total = len(ts)
    t_prev = ts[1:] + [-1]
    guidance = dcfg.guidance_scale
    branches = [FULL] * total if plan is None else plan_to_branches(plan, total)
    e_sk, e_rf = (0, 0) if plan is None else _entry_steps(ucfg, plan)
    capture = () if plan is None else (e_sk, e_rf)
    ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)
    if mask is not None:
        x_init = torch.zeros_like(x_t) if x_init is None else x_init
        noise0 = torch.zeros_like(x_t) if noise0 is None else noise0

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
        if mask is not None:
            ab = D._alpha_prev(sched, torch.tensor(tp, device=x.device))
            known = torch.sqrt(ab) * x_init + torch.sqrt(1.0 - ab) * noise0
            x = torch.where(mask >= 1.0, x, mask * x + (1.0 - mask) * known)
    return x


def denoise_with_capture(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params: Params,
    x_t: torch.Tensor,  # [B, L, C] initial noise
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    capture_steps: tuple[int, ...],
    *,
    backend=None,
) -> tuple[torch.Tensor, list[dict[int, torch.Tensor]]]:
    """Full sampling with per-timestep feature capture (calibration path).

    Returns the final latent and ``traj[t][step]``, the [2B, ...]
    cond/uncond-stacked main-branch input of up-step ``step`` at sampling
    step ``t``, copied to host memory as soon as the step has run: the
    trajectory of a large model does not fit beside it on the device, and a
    copy cannot change when a later call writes into its source.
    """
    sched = D.make_schedule(dcfg, x_t.device)
    ts = [int(t) for t in D.sample_timesteps(dcfg)]
    ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)
    x = x_t
    pndm = D.pndm_init(x_t.shape, x_t.dtype, x_t.device)
    traj = []
    for t, tp in zip(ts, ts[1:] + [-1]):
        eps, cap = cfg_unet_step(
            ucfg, params, dcfg.guidance_scale, x, t, ctx2,
            capture=tuple(capture_steps), backend=backend,
        )
        if dcfg.scheduler == "pndm":
            x, pndm = D.pndm_step(sched, pndm, x, eps, t, tp)
        else:
            x = D.ddim_step(sched, x, eps, t, tp)
        traj.append({k: v.to("cpu", copy=True) for k, v in cap.items()})
    return x, traj
