"""Per-lane sampler state for step-level continuous batching.

Port of ``repro/serving/lanes.py``.  The lane
state is a set of lane-major tensors updated **in place**: where the JAX
micro-step donates its input state and returns a new one, :func:`admit`,
:func:`release` and the micro-step here write into the tensors they are
given and return nothing.

Layout (unchanged from the JAX package):

* ``x`` is [N, L, C], the PNDM ring [N, 4, L, C];
* the sketch/refine feature caches and the conditioning (``ctx2``, and
  ``pooled2`` / ``time_ids2`` for a U-Net with SDXL's added conditioning,
  None otherwise) keep the CFG-doubled ``[2N, ...]`` layout of
  :func:`cfg_unet_step`: rows ``i`` and ``N + i`` belong to lane ``i``;
* plans are padded to ``max_steps``; ``step[i] < n_steps[i]`` marks a live
  lane, and an empty lane has ``n_steps == 0`` and all-zero tensors;
* ``thr`` holds each lane's per-step cache threshold (the quality policy's
  resolution), compared on the device in float32 by the cached micro-step.

The sharded engine's lanes (:class:`ShardedLaneState`) are one
:class:`LaneState` a shard, each on its shard's own device, and its
micro-step runs the single-device micro-step on each shard with the
shard's own branch class.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.common import trace as T
from repro_torch.common.sharding import device_guard
from repro_torch.common.types import DiffusionConfig, PASPlan, UNetConfig, added_cond_dim
from repro_torch.core import sampler as SM
from repro_torch.models import diffusion as D
from repro_torch.models.backend import resolve_backend
from repro_torch.serving.cache import CacheState, select_entry_features

Params = dict[str, Any]

#: the work range of a micro-step of each branch class
STEP_RANGES = {SM.FULL: "step_full", SM.SKETCH: "step_sketch", SM.REFINE: "step_refine"}


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
    thr: torch.Tensor  # [N, max_steps] float32 per-step cache threshold
    #: [N, L, 1] inpaint mask (1 = generate, 0 = keep the init latent); all
    #: ones for txt2img, where the per-step blend is exactly the identity
    mask: torch.Tensor
    x_init: torch.Tensor  # [N, L, C] known latent under the mask
    noise0: torch.Tensor  # [N, L, C] noise re-noising the known region
    #: [2N, pooled_dim] pooled prompt vector (uncond rows 0) and [2N,
    #: n_time_ids] time ids (the same in both rows); None for a U-Net
    #: without added conditioning
    pooled2: torch.Tensor | None = None
    time_ids2: torch.Tensor | None = None

    @property
    def n_lanes(self) -> int:
        return self.x.shape[0]


class LanePlan(NamedTuple):
    """Host-side padded plan arrays for one request."""

    branches: np.ndarray  # [max_steps] int32
    ts: np.ndarray  # [max_steps] int32
    t_prev: np.ndarray  # [max_steps] int32
    n_steps: int
    thr: np.ndarray  # [max_steps] float32 per-step cache threshold (0 = never reuse)


def make_plan_arrays(
    dcfg: DiffusionConfig,
    timesteps: int,
    plan: PASPlan | None,
    max_steps: int,
    threshold: float | Callable[[np.ndarray], np.ndarray] = 0.0,
    base_timesteps: int | None = None,
) -> LanePlan:
    """One request's branch/timestep/threshold vectors, padded to ``max_steps``.

    ``threshold`` is a scalar or a callable from the steps' train timesteps
    to per-step thresholds (the quality policy's per-bucket form).
    ``base_timesteps`` is the img2img truncation
    (:func:`repro_torch.core.sampler.truncated_timesteps`); None is the
    stock schedule.
    """
    if timesteps > max_steps:
        raise ValueError(f"request wants {timesteps} steps, engine max is {max_steps}")
    base = timesteps if base_timesteps is None else int(base_timesteps)
    ts = SM.truncated_timesteps(dcfg, base, timesteps).numpy().astype(np.int32)
    t_prev = np.concatenate([ts[1:], np.array([-1], np.int32)])
    branches = (
        np.full((timesteps,), SM.FULL, np.int32) if plan is None
        else np.asarray(SM.plan_to_branches(plan, timesteps), np.int32)
    )
    thr = np.asarray(
        threshold(ts) if callable(threshold) else np.full((timesteps,), threshold), np.float32
    )
    if thr.shape != (timesteps,):
        raise ValueError(f"threshold resolver returned shape {thr.shape}, want ({timesteps},)")

    def pad(a: np.ndarray, dtype=np.int32) -> np.ndarray:
        out = np.zeros((max_steps,), dtype)
        out[:timesteps] = a
        return out

    return LanePlan(pad(branches), pad(ts), pad(t_prev), timesteps, pad(thr, np.float32))


def init_lanes(
    ucfg: UNetConfig, n_lanes: int, max_steps: int, e_sk: int, e_rf: int, device
) -> LaneState:
    """All-empty lane state (every lane has ``n_steps == 0``)."""
    L, c = ucfg.latent_size**2, ucfg.in_channels
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i64 = torch.int64
    added = added_cond_dim(ucfg) > 0
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
        thr=z(n_lanes, max_steps),
        mask=torch.ones((n_lanes, L, 1), device=device),
        x_init=z(n_lanes, L, c),
        noise0=z(n_lanes, L, c),
        pooled2=z(2 * n_lanes, ucfg.pooled_dim) if added else None,
        time_ids2=z(2 * n_lanes, ucfg.n_time_ids) if added else None,
    )


def admit(
    state: LaneState,
    lane: int,
    noise: torch.Tensor,  # [L, C] request's entry latent (noise or seeded init)
    ctx: torch.Tensor,  # [ctx_len, ctx_dim]
    plan: LanePlan,
    mask: torch.Tensor | None = None,  # [L, 1] inpaint mask; None = all ones
    x_init: torch.Tensor | None = None,  # [L, C] known latent; None = zeros
    noise0: torch.Tensor | None = None,  # [L, C] known-region noise; None = zeros
    pooled: torch.Tensor | None = None,  # [pooled_dim] where the lanes hold it
    time_ids: torch.Tensor | None = None,  # [n_time_ids] where the lanes hold them
) -> None:
    """Scatter one request into an (empty) lane, resetting its sampler state,
    in place.  The unconditional row takes a zero pooled vector and the
    request's own time ids (SDXL's empty-prompt convention)."""
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
    if state.pooled2 is not None:
        state.pooled2[lane] = pooled
        state.pooled2[n + lane] = 0.0
        state.time_ids2[lane] = time_ids
        state.time_ids2[n + lane] = time_ids
    state.branches[lane] = torch.from_numpy(plan.branches).to(dev)
    state.ts[lane] = torch.from_numpy(plan.ts).to(dev)
    state.t_prev[lane] = torch.from_numpy(plan.t_prev).to(dev)
    state.step[lane] = 0
    state.n_steps[lane] = plan.n_steps
    state.thr[lane] = torch.from_numpy(plan.thr).to(dev)
    state.mask[lane] = 1.0 if mask is None else mask
    state.x_init[lane] = 0.0 if x_init is None else x_init
    state.noise0[lane] = 0.0 if noise0 is None else noise0


def release(state: LaneState, lane: int) -> None:
    """Mark a lane empty (retirement without immediate backfill), in place."""
    state.step[lane] = 0
    state.n_steps[lane] = 0


class _Batch(NamedTuple):
    """What a micro-step reads of the lanes its U-Net runs on: lane-major
    [n, ...] tensors, then the CFG-doubled [2n, ...] rows."""

    x: torch.Tensor
    ets: torch.Tensor
    n_ets: torch.Tensor
    mask: torch.Tensor
    x_init: torch.Tensor
    noise0: torch.Tensor
    f_sk: torch.Tensor
    f_rf: torch.Tensor
    ctx2: torch.Tensor
    pooled2: torch.Tensor | None
    time_ids2: torch.Tensor | None


#: the :class:`_Batch` fields in the CFG-doubled layout
_ROW_FIELDS = ("f_sk", "f_rf", "ctx2", "pooled2", "time_ids2")


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
    """Build the continuous-batching micro-step
    ``micro_step(state, b_star, sel, feat_src=None, feat_dist=None, cache=None, *,
    n_advanced=None, lanes=None)``.

    It advances, by exactly one denoise step and in place, every lane the
    host-chosen advance mask ``sel`` ([N] bool) selects, in branch class
    ``b_star``, which the host knows, so only that branch runs (the JAX
    version's ``lax.switch``).  ``lanes`` ([n] int64, on the state's
    device) are the indices of the lanes ``sel`` selects, which the host
    also knows.  Where they are given and fewer than N, the U-Net, PNDM and
    the inpaint blend run on those n lanes alone (2n CFG rows, gathered at
    ``cat(lanes, N + lanes)``), and the step writes their state back in
    place.  Otherwise one batched U-Net call runs over the whole lane batch,
    and lanes outside ``sel`` (and empty lanes) are carried through
    unchanged by masking.  Either way a lane outside ``sel`` keeps every bit.

    Without a ``cache`` the partial branches consume the lane's own captured
    features.  With one, ``feat_src`` ([N] slot index, -1 = own) and
    ``feat_dist`` ([N] float32 probed signature distance) pick cached
    features: a slot is consumed only where ``feat_dist`` is strictly below
    the lane's own threshold at its current step (``state.thr``), compared
    on the device in float32, so a threshold-0 lane never consumes a slot
    whatever the host says.  A SKETCH step adopts the selected entry as the
    lane's sketch/refine cache (a demoted FULL skipped its own refresh); a
    REFINE step consumes it for that step only.  With no slot used the
    selection is an exact passthrough, bit-identical to the uncached step.

    While a profiler collects, the step's model work, from the lanes'
    gather to the last state write, runs in a ``step_<class>`` range
    (:mod:`repro_torch.common.trace`) carrying the lanes advanced
    (``n_advanced``, or the length of ``lanes``; counted on the device, a
    sync, where the caller says neither) and the lanes the U-Net ran on.
    The plan gathers before it and the step count after it stay with the
    range around the call, which so keeps the micro-step's first and last
    kernels.
    """
    bk = resolve_backend(backend)
    sched = D.make_schedule(dcfg, device)
    guidance = dcfg.guidance_scale
    use_pndm = dcfg.scheduler == "pndm"

    def denoise(b_star, b: _Batch, t, tp, src, use, cache):
        """One denoise step of the batch ``b``: (x, ets, n_ets, f_sk, f_rf)
        after it, each of the last four ``b``'s own where the step leaves
        it as it was."""
        entry_sk, entry_rf = b.f_sk, b.f_rf
        if use is not None:
            entry_rf = select_entry_features(b.f_rf, cache.f_rf, src, use)
            if b_star == SM.SKETCH:
                entry_sk = select_entry_features(b.f_sk, cache.f_sk, src, use)

        f_sk_new, f_rf_new = b.f_sk, b.f_rf
        added = dict(pooled2=b.pooled2, time_ids2=b.time_ids2)
        if b_star == SM.FULL:
            eps, cap = SM.cfg_unet_step(
                ucfg, params, guidance, b.x, t, b.ctx2, capture=(e_sk, e_rf), backend=bk,
                **added,
            )
            f_sk_new, f_rf_new = cap[e_sk], cap[e_rf]
        elif b_star == SM.SKETCH:
            eps, _ = SM.cfg_unet_step(
                ucfg, params, guidance, b.x, t, b.ctx2,
                entry_step=e_sk, entry_feat=entry_sk, backend=bk, **added,
            )
            # the selection becomes the lane's features of record
            f_sk_new, f_rf_new = entry_sk, entry_rf
        else:
            eps, _ = SM.cfg_unet_step(
                ucfg, params, guidance, b.x, t, b.ctx2,
                entry_step=e_rf, entry_feat=entry_rf, backend=bk, **added,
            )

        if use_pndm:
            x_new, ets_new, n_new = D.pndm_step_batched(sched, b.ets, b.n_ets, b.x, eps, t, tp)
        else:
            x_new = D.ddim_step_batched(sched, b.x, eps, t, tp)
            ets_new, n_new = b.ets, b.n_ets

        # inpaint blend: re-noise the known region to each lane's target
        # timestep; where() keeps x_new exactly under an all-ones mask
        ab = D._alpha_prev(sched, tp)[:, None, None]
        known = torch.sqrt(ab) * b.x_init + torch.sqrt(1.0 - ab) * b.noise0
        x_new = torch.where(b.mask >= 1.0, x_new, b.mask * x_new + (1.0 - b.mask) * known)
        return x_new, ets_new, n_new, f_sk_new, f_rf_new

    def micro_step(
        state: LaneState,
        b_star: int,
        sel: torch.Tensor,
        feat_src: torch.Tensor | None = None,  # [N] int64 cache slot per lane, -1 = own
        feat_dist: torch.Tensor | None = None,  # [N] float32 probed distance (inf = none)
        cache: CacheState | None = None,
        *,
        n_advanced: int | None = None,
        lanes: torch.Tensor | None = None,  # [n] int64 indices of the lanes sel selects
    ) -> None:
        if b_star not in STEP_RANGES:
            raise ValueError(f"unknown branch class {b_star}")
        n = state.n_lanes
        idx = torch.clamp(state.step, max=state.branches.shape[1] - 1)[:, None]
        t = torch.gather(state.ts, 1, idx)[:, 0]
        tp = torch.gather(state.t_prev, 1, idx)[:, 0]
        if lanes is not None:
            n_advanced = lanes.shape[0]
        compact = lanes is not None and n_advanced < n

        with T.work(STEP_RANGES[b_star], _lanes, sel, n_advanced, n_advanced if compact else n):
            use = None
            if cache is not None and b_star != SM.FULL:
                thr_t = torch.gather(state.thr, 1, idx)[:, 0]
                use = (feat_src >= 0) & (feat_dist < thr_t)
            if not compact:
                b = _Batch(*(getattr(state, f) for f in _Batch._fields))
                x_new, ets_new, n_new, f_sk_new, f_rf_new = denoise(
                    b_star, b, t, tp, feat_src, use, cache)
                m3 = sel[:, None, None]
                sel2 = torch.cat([sel, sel], dim=0)[:, None, None]
                state.x.copy_(torch.where(m3, x_new, state.x))
                state.ets.copy_(torch.where(sel[:, None, None, None], ets_new, state.ets))
                state.n_ets.copy_(torch.where(sel, n_new, state.n_ets))
                state.f_sk.copy_(torch.where(sel2, f_sk_new, state.f_sk))
                state.f_rf.copy_(torch.where(sel2, f_rf_new, state.f_rf))
            else:
                rows = torch.cat([lanes, lanes + n])
                b = _Batch(*(_gather(getattr(state, f), rows if f in _ROW_FIELDS else lanes)
                             for f in _Batch._fields))
                if use is not None:
                    feat_src, use = feat_src.index_select(0, lanes), use.index_select(0, lanes)
                new = denoise(b_star, b, t.index_select(0, lanes), tp.index_select(0, lanes),
                              feat_src, use, cache)
                for name, old, value in zip(("x", "ets", "n_ets", "f_sk", "f_rf"),
                                            (b.x, b.ets, b.n_ets, b.f_sk, b.f_rf), new):
                    if value is not old:  # a tensor the step left as it was needs no write
                        getattr(state, name).index_copy_(
                            0, rows if name in _ROW_FIELDS else lanes, value)
        state.step += sel.to(state.step.dtype)

    return micro_step


def _gather(t: torch.Tensor | None, index: torch.Tensor) -> torch.Tensor | None:
    return None if t is None else t.index_select(0, index)


def _lanes(sel: torch.Tensor, n_advanced: int | None, n_computed: int) -> tuple[int, int]:
    """A micro-step range's two integers: lanes advanced, and lanes the
    U-Net ran on."""
    return (int(sel.sum()) if n_advanced is None else n_advanced), n_computed


# ---------------------------------------------------------------------------
# Lane shards: one LaneState a device.
#
# The JAX package lays the sharded lanes out as [N, 2, ...] so GSPMD can
# shard every leaf on its leading axis, and runs ONE shard_map program in
# which each shard switches on its own branch class.  Here shard d is a
# plain LaneState of P = N / n_shards lanes on its own device, in the
# single-device [2P, ...] CFG layout, and the sharded micro-step issues the
# single-device micro-step on each shard in turn.  The shard-local math is
# the same as the JAX package's (its local body is the single-device body
# on P lanes); the launches are asynchronous, so shards on different cards
# overlap.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedLaneState:
    """Contiguous lane shards: ``shards[d]`` holds lanes ``[d * P, (d + 1) * P)``."""

    shards: list[LaneState]

    @property
    def lanes_per_shard(self) -> int:
        return self.shards[0].n_lanes

    def locate(self, lane: int) -> tuple[int, int]:
        """(shard, lane within the shard) of a global lane index."""
        return divmod(int(lane), self.lanes_per_shard)


def init_sharded_lanes(
    ucfg: UNetConfig, n_lanes: int, max_steps: int, e_sk: int, e_rf: int, devices
) -> ShardedLaneState:
    """All-empty lanes, ``n_lanes / len(devices)`` on each device."""
    if n_lanes % len(devices) != 0:
        raise ValueError(f"n_lanes={n_lanes} must divide over {len(devices)} shards")
    p = n_lanes // len(devices)
    return ShardedLaneState([init_lanes(ucfg, p, max_steps, e_sk, e_rf, dev) for dev in devices])


def make_sharded_admit():
    """:func:`admit` on the lane's own shard, its tensors moved to the
    shard's device: ``admit(state, lane, noise, ctx, plan, mask, x_init, noise0,
    pooled=, time_ids=)``."""

    def admit_sharded(
        state: ShardedLaneState, lane: int, noise, ctx, plan: LanePlan,
        mask=None, x_init=None, noise0=None, pooled=None, time_ids=None,
    ) -> None:
        s, i = state.locate(lane)
        shard = state.shards[s]
        dev = shard.x.device
        to = lambda t: None if t is None else t.to(dev)  # noqa: E731
        admit(shard, i, to(noise), to(ctx), plan, to(mask), to(x_init), to(noise0),
              pooled=to(pooled), time_ids=to(time_ids))

    return admit_sharded


def make_sharded_release():
    """:func:`release` on the lane's own shard: ``release(state, lane)``."""

    def release_sharded(state: ShardedLaneState, lane: int) -> None:
        s, i = state.locate(lane)
        release(state.shards[s], i)

    return release_sharded


def make_sharded_micro_step(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params_on,
    e_sk: int,
    e_rf: int,
    devices,
    *,
    backend=None,
):
    """Build the sharded micro-step
    ``micro_step(state, b_arr, sel, feat_src=None, feat_dist=None, cache=None)``.

    ``params_on`` maps each distinct device to the U-Net weights held
    there (one copy a card, shared by the shards on it).  The host arrays
    are global: ``b_arr`` [n_shards] is each shard's own branch class,
    ``sel`` [N] the advance mask, ``feat_src`` [N] *shard-local* slot
    indices (-1 = own features) and ``feat_dist`` [N] float32 probed
    distances; ``cache`` is the sharded cache's per-shard
    :class:`~repro_torch.serving.cache.CacheState` list.  Shard ``d`` runs
    :func:`make_micro_step`'s step on its P lanes in class ``b_arr[d]``,
    with its device current, so every kernel launches there and the
    float32 threshold comparison runs there; its U-Net runs on the shard's
    advancing lanes alone (their shard-local indices) where fewer than P
    advance.  A shard whose mask is all false (an idle shard, parked on
    REFINE by the engine) is not run: its step would change nothing.
    """
    steps = {
        dev: make_micro_step(ucfg, dcfg, params_on[dev], e_sk, e_rf, device=dev, backend=backend)
        for dev in dict.fromkeys(devices)
    }

    def micro_step(
        state: ShardedLaneState,
        b_arr: np.ndarray,
        sel: np.ndarray,
        feat_src: np.ndarray | None = None,
        feat_dist: np.ndarray | None = None,
        cache=None,
    ) -> None:
        p = state.lanes_per_shard
        for d, (dev, shard) in enumerate(zip(devices, state.shards)):
            seg = slice(d * p, (d + 1) * p)
            if not sel[seg].any():
                continue
            to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            with device_guard(dev):
                mine = np.flatnonzero(sel[seg])  # shard-local lanes
                lanes = to(mine) if len(mine) < p else None
                args = () if cache is None else (to(feat_src[seg]), to(feat_dist[seg]), cache[d])
                steps[dev](shard, int(b_arr[d]), to(sel[seg]), *args,
                           n_advanced=len(mine), lanes=lanes)

    return micro_step
