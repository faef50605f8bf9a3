"""Per-lane sampler state for step-level continuous batching.

Port of the single-device half of ``repro/serving/lanes.py``.  The lane
state is a set of lane-major tensors updated **in place**: where the JAX
micro-step donates its input state and returns a new one, :func:`admit`,
:func:`release` and the micro-step here write into the tensors they are
given and return nothing.

Layout (unchanged from the JAX package):

* ``x`` is [N, L, C], the PNDM ring [N, 4, L, C];
* the sketch/refine feature caches and the conditioning keep the
  CFG-doubled ``[2N, ...]`` layout of :func:`cfg_unet_step`: rows ``i`` and
  ``N + i`` belong to lane ``i``;
* plans are padded to ``max_steps``; ``step[i] < n_steps[i]`` marks a live
  lane, and an empty lane has ``n_steps == 0`` and all-zero tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.common.types import DiffusionConfig, PASPlan, UNetConfig
from repro_torch.core import sampler as SM
from repro_torch.models import diffusion as D
from repro_torch.models.backend import resolve_backend

Params = dict[str, Any]


@dataclasses.dataclass
class LaneState:
    """All per-lane sampler state, as lane-major tensors on one device."""

    x: torch.Tensor  # [N, L, C] current latent
    ets: torch.Tensor  # [N, 4, L, C] PNDM eps ring
    n_ets: torch.Tensor  # [N] PNDM warmup count
    f_sk: torch.Tensor  # [2N, L_sk, C_sk] sketch-entry feature cache
    f_rf: torch.Tensor  # [2N, L_rf, C_rf] refine-entry feature cache
    ctx2: torch.Tensor  # [2N, ctx_len, ctx_dim] CFG-doubled conditioning (uncond rows 0)
    branches: torch.Tensor  # [N, max_steps] FULL/SKETCH/REFINE per step
    ts: torch.Tensor  # [N, max_steps] timestep per step
    t_prev: torch.Tensor  # [N, max_steps] successor timestep (-1 at the end)
    step: torch.Tensor  # [N] current step index into the plan
    n_steps: torch.Tensor  # [N] plan length; 0 marks an empty lane
    #: [N, L, 1] inpaint mask; all ones for txt2img, where the per-step blend
    #: is exactly the identity (kept so the micro-step is the JAX one)
    mask: torch.Tensor
    x_init: torch.Tensor  # [N, L, C] known latent under the mask
    noise0: torch.Tensor  # [N, L, C] noise re-noising the known region

    @property
    def n_lanes(self) -> int:
        return self.x.shape[0]


class LanePlan(NamedTuple):
    """Host-side padded plan arrays for one request."""

    branches: np.ndarray  # [max_steps] int32
    ts: np.ndarray  # [max_steps] int32
    t_prev: np.ndarray  # [max_steps] int32
    n_steps: int


def make_plan_arrays(
    dcfg: DiffusionConfig, timesteps: int, plan: PASPlan | None, max_steps: int
) -> LanePlan:
    """One request's branch/timestep vectors, padded to ``max_steps``."""
    if timesteps > max_steps:
        raise ValueError(f"request wants {timesteps} steps, engine max is {max_steps}")
    if timesteps < 1:
        raise ValueError(f"request wants {timesteps} steps")
    stride = dcfg.timesteps_train // timesteps
    ts = (np.arange(timesteps, dtype=np.int64) * stride)[::-1].astype(np.int32)
    t_prev = np.concatenate([ts[1:], np.array([-1], np.int32)])
    branches = (
        np.full((timesteps,), SM.FULL, np.int32) if plan is None
        else np.asarray(SM.plan_to_branches(plan, timesteps), np.int32)
    )

    def pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros((max_steps,), np.int32)
        out[:timesteps] = a
        return out

    return LanePlan(pad(branches), pad(ts), pad(t_prev), timesteps)


def init_lanes(
    ucfg: UNetConfig, n_lanes: int, max_steps: int, e_sk: int, e_rf: int, device
) -> LaneState:
    """All-empty lane state (every lane has ``n_steps == 0``)."""
    L, c = ucfg.latent_size**2, ucfg.in_channels
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i64 = torch.int64
    return LaneState(
        x=z(n_lanes, L, c),
        ets=z(n_lanes, 4, L, c),
        n_ets=z(n_lanes, dtype=i64),
        f_sk=z(*SM.feat_shape(ucfg, e_sk, 2 * n_lanes)),
        f_rf=z(*SM.feat_shape(ucfg, e_rf, 2 * n_lanes)),
        ctx2=z(2 * n_lanes, ucfg.ctx_len, ucfg.ctx_dim),
        branches=z(n_lanes, max_steps, dtype=i64),
        ts=z(n_lanes, max_steps, dtype=i64),
        t_prev=z(n_lanes, max_steps, dtype=i64),
        step=z(n_lanes, dtype=i64),
        n_steps=z(n_lanes, dtype=i64),
        mask=torch.ones((n_lanes, L, 1), device=device),
        x_init=z(n_lanes, L, c),
        noise0=z(n_lanes, L, c),
    )


def admit(
    state: LaneState,
    lane: int,
    noise: torch.Tensor,  # [L, C] request's entry latent
    ctx: torch.Tensor,  # [ctx_len, ctx_dim]
    plan: LanePlan,
) -> None:
    """Scatter one txt2img request into an (empty) lane, in place."""
    n = state.n_lanes
    dev = state.x.device
    state.x[lane] = noise
    state.ets[lane] = 0.0
    state.n_ets[lane] = 0
    for f in (state.f_sk, state.f_rf):
        f[lane] = 0.0
        f[n + lane] = 0.0
    state.ctx2[lane] = ctx
    state.ctx2[n + lane] = 0.0
    state.branches[lane] = torch.from_numpy(plan.branches).to(dev)
    state.ts[lane] = torch.from_numpy(plan.ts).to(dev)
    state.t_prev[lane] = torch.from_numpy(plan.t_prev).to(dev)
    state.step[lane] = 0
    state.n_steps[lane] = plan.n_steps
    state.mask[lane] = 1.0
    state.x_init[lane] = 0.0
    state.noise0[lane] = 0.0


def release(state: LaneState, lane: int) -> None:
    """Mark a lane empty (retirement without immediate backfill), in place."""
    state.step[lane] = 0
    state.n_steps[lane] = 0


def make_micro_step(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params: Params,
    e_sk: int,
    e_rf: int,
    *,
    device,
    backend=None,
):
    """Build the continuous-batching micro-step ``micro_step(state, b_star, sel)``.

    It advances, by exactly one denoise step and in place, every lane the
    host-chosen advance mask ``sel`` ([N] bool) selects: one batched U-Net
    call over the whole lane batch in branch class ``b_star``, which the
    host knows, so only that branch runs (the JAX version's ``lax.switch``).
    Lanes outside ``sel`` (and empty lanes) are carried through unchanged by
    masking.  Partial branches consume the lane's own captured features; the
    feature cache's cached form is not ported yet.
    """
    bk = resolve_backend(backend)
    sched = D.make_schedule(dcfg, device)
    guidance = dcfg.guidance_scale
    use_pndm = dcfg.scheduler == "pndm"

    def micro_step(state: LaneState, b_star: int, sel: torch.Tensor) -> None:
        idx = torch.clamp(state.step, max=state.branches.shape[1] - 1)[:, None]
        t = torch.gather(state.ts, 1, idx)[:, 0]
        tp = torch.gather(state.t_prev, 1, idx)[:, 0]

        f_sk_new, f_rf_new = state.f_sk, state.f_rf
        if b_star == SM.FULL:
            eps, cap = SM.cfg_unet_step(
                ucfg, params, guidance, state.x, t, state.ctx2, capture=(e_sk, e_rf), backend=bk
            )
            f_sk_new, f_rf_new = cap[e_sk], cap[e_rf]
        elif b_star == SM.SKETCH:
            eps, _ = SM.cfg_unet_step(
                ucfg, params, guidance, state.x, t, state.ctx2,
                entry_step=e_sk, entry_feat=state.f_sk, backend=bk,
            )
        elif b_star == SM.REFINE:
            eps, _ = SM.cfg_unet_step(
                ucfg, params, guidance, state.x, t, state.ctx2,
                entry_step=e_rf, entry_feat=state.f_rf, backend=bk,
            )
        else:
            raise ValueError(f"unknown branch class {b_star}")

        if use_pndm:
            x_new, ets_new, n_new = D.pndm_step_batched(
                sched, state.ets, state.n_ets, state.x, eps, t, tp
            )
        else:
            x_new = D.ddim_step_batched(sched, state.x, eps, t, tp)
            ets_new, n_new = state.ets, state.n_ets

        # inpaint blend (all-ones mask for txt2img: where() keeps x_new exactly)
        ab = D._alpha_prev(sched, tp)[:, None, None]
        known = torch.sqrt(ab) * state.x_init + torch.sqrt(1.0 - ab) * state.noise0
        x_new = torch.where(
            state.mask >= 1.0, x_new, state.mask * x_new + (1.0 - state.mask) * known
        )

        m3 = sel[:, None, None]
        sel2 = torch.cat([sel, sel], dim=0)[:, None, None]
        state.x.copy_(torch.where(m3, x_new, state.x))
        state.ets.copy_(torch.where(sel[:, None, None, None], ets_new, state.ets))
        state.n_ets.copy_(torch.where(sel, n_new, state.n_ets))
        state.f_sk.copy_(torch.where(sel2, f_sk_new, state.f_sk))
        state.f_rf.copy_(torch.where(sel2, f_rf_new, state.f_rf))
        state.step += sel.to(state.step.dtype)

    return micro_step
