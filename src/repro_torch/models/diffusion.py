"""Diffusion noise schedules and samplers (DDIM + PNDM, as in the paper).

Port of ``repro/models/diffusion.py``.  Every function is a plain function
on tensors, computed in float32 as the JAX version computes it; timestep
tensors are int64 indices into the train schedule.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.common.types import DiffusionConfig


class NoiseSchedule(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor  # \bar{alpha}_t

    @property
    def num_train_steps(self) -> int:
        return self.betas.shape[0]


def make_schedule(cfg: DiffusionConfig, device=None) -> NoiseSchedule:
    t = cfg.timesteps_train
    if cfg.beta_schedule == "scaled_linear":  # StableDiff's schedule
        betas = torch.linspace(
            cfg.beta_start**0.5, cfg.beta_end**0.5, t, dtype=torch.float32, device=device
        ) ** 2
    else:
        betas = torch.linspace(cfg.beta_start, cfg.beta_end, t, dtype=torch.float32, device=device)
    return NoiseSchedule(betas=betas, alphas_cumprod=torch.cumprod(1.0 - betas, dim=0))


def sample_timesteps(cfg: DiffusionConfig, device=None) -> torch.Tensor:
    """The T sampling timesteps (descending), uniform-strided like PNDM."""
    stride = cfg.timesteps_train // cfg.timesteps_sample
    return (torch.arange(cfg.timesteps_sample, device=device) * stride).flip(0)


def q_sample(
    sched: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0). t: [B] ints into the train schedule."""
    ab = sched.alphas_cumprod[t]
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return torch.sqrt(ab).reshape(shape) * x0 + torch.sqrt(1 - ab).reshape(shape) * noise


def _alpha_prev(sched: NoiseSchedule, t_prev: torch.Tensor) -> torch.Tensor:
    """alphas_cumprod at ``t_prev``; 1 where ``t_prev < 0`` (final step to x0)."""
    ab = sched.alphas_cumprod[torch.clamp(t_prev, min=0)]
    return torch.where(t_prev >= 0, ab, torch.ones_like(ab))


def ddim_step(
    sched: NoiseSchedule, x: torch.Tensor, eps: torch.Tensor, t, t_prev
) -> torch.Tensor:
    """Deterministic DDIM (eta=0) at one scalar timestep pair."""
    t = torch.as_tensor(t, device=x.device)
    t_prev = torch.as_tensor(t_prev, device=x.device)
    ab_t = sched.alphas_cumprod[t]
    ab_p = _alpha_prev(sched, t_prev)
    x0 = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    return torch.sqrt(ab_p) * x0 + torch.sqrt(1 - ab_p) * eps


def ddim_step_batched(
    sched: NoiseSchedule,
    x: torch.Tensor,
    eps: torch.Tensor,
    t: torch.Tensor,
    t_prev: torch.Tensor,
) -> torch.Tensor:
    """DDIM with a per-sample timestep vector (``t``/``t_prev``: [B])."""
    bshape = (-1,) + (1,) * (x.ndim - 1)
    ab_t = sched.alphas_cumprod[t].reshape(bshape)
    ab_p = _alpha_prev(sched, t_prev).reshape(bshape)
    x0 = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    return torch.sqrt(ab_p) * x0 + torch.sqrt(1 - ab_p) * eps


class PNDMState(NamedTuple):
    ets: torch.Tensor  # [4, ...] ring of recent eps predictions
    n_ets: int  # warmup count


def pndm_init(shape, dtype=torch.float32, device=None) -> PNDMState:
    return PNDMState(ets=torch.zeros((4,) + tuple(shape), dtype=dtype, device=device), n_ets=0)


def _plms_eps(ets: torch.Tensor, n, axis: int) -> torch.Tensor:
    """Adams-Bashforth eps' of order ``n`` over the ring's ``axis``."""
    e = [ets.select(axis, i) for i in range(4)]
    e1 = e[0]
    e2 = (3 * e[0] - e[1]) / 2
    e3 = (23 * e[0] - 16 * e[1] + 5 * e[2]) / 12
    e4 = (55 * e[0] - 59 * e[1] + 37 * e[2] - 9 * e[3]) / 24
    return torch.where(n == 1, e1, torch.where(n == 2, e2, torch.where(n == 3, e3, e4)))


def pndm_step(
    sched: NoiseSchedule, state: PNDMState, x: torch.Tensor, eps: torch.Tensor, t, t_prev
) -> tuple[torch.Tensor, PNDMState]:
    """PLMS multistep: warms up like DDIM, then 4th-order Adams-Bashforth."""
    ets = torch.roll(state.ets, 1, dims=0)
    ets[0] = eps
    n = min(state.n_ets + 1, 4)
    eps_prime = _plms_eps(ets, torch.tensor(n, device=x.device), 0)
    return ddim_step(sched, x, eps_prime, t, t_prev), PNDMState(ets=ets, n_ets=n)


def pndm_step_batched(
    sched: NoiseSchedule,
    ets: torch.Tensor,  # [B, 4, ...] per-sample ring of recent eps predictions
    n_ets: torch.Tensor,  # [B] per-sample warmup counts
    x: torch.Tensor,  # [B, ...]
    eps: torch.Tensor,  # [B, ...]
    t: torch.Tensor,  # [B]
    t_prev: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PLMS with per-sample timesteps and per-sample multistep history.

    Returns (x_prev, ets, n_ets) as new tensors, so callers can mask the
    update per lane.
    """
    ets = torch.roll(ets, 1, dims=1)
    ets[:, 0] = eps
    n = torch.clamp(n_ets + 1, max=4)
    nb = n.reshape((-1,) + (1,) * (x.ndim - 1))
    eps_prime = _plms_eps(ets, nb, 1)
    return ddim_step_batched(sched, x, eps_prime, t, t_prev), ets, n


def cfg_eps(
    eps_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    t: torch.Tensor,
    ctx_cond: torch.Tensor,
    ctx_uncond: torch.Tensor,
    guidance: float,
) -> torch.Tensor:
    """Runs the noise net on [cond; uncond] in one batched call (as deployed)."""
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    ctx2 = torch.cat([ctx_cond, ctx_uncond], dim=0)
    e_c, e_u = torch.chunk(eps_fn(x2, t2, ctx2), 2, dim=0)
    return e_u + guidance * (e_c - e_u)
