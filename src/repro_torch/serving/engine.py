"""Continuous-batching diffusion serving engine (+ static lockstep baseline).

Port of ``repro/serving/engine.py``.  The engine advances a fixed set of
*lanes* through the PAS denoise loop one micro-step at a time.  Lanes hold
requests at different denoise steps; each micro-step runs one branch class
(FULL / SKETCH / REFINE), chosen by the packing policy, as one batched
U-Net call.  A lane retires through the VAE decoder the moment its own
schedule ends and is backfilled from the admission queue at once.

Requests may be txt2img, img2img (a strength-truncated schedule entered
through ``q_sample``) or inpaint (a mask blended every step), and may carry
a quality policy (``repro_torch.serving.policy``) whose per-step cache
thresholds the micro-step compares on the device.  With the feature cache
on (``cache_mode`` "intra" or "cross", ``repro_torch.serving.cache``), a
planned FULL step with a warm, close-enough slot runs as SKETCH on the
slot's features, and a planned SKETCH step whose policy allows it as
REFINE.  :class:`StaticServer` is the fixed-size lockstep baseline.

:class:`ShardedDiffusionEngine` holds one lane shard per device of a
device list, each with its own branch vote and its own slot ring over one
shared spill ring, and admits warm requests to the shard whose ring holds
their slots; :func:`make_serving_engine` picks the engine for
``n_shards``.  The HTTP serving layer drives the engine from its own thread
(``repro_torch.serving.driver``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.common import trace as T
from repro_torch.common.sharding import lane_devices, resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.common.types import DiffusionConfig, PASPlan, UNetConfig
from repro_torch.core import sampler as SM
from repro_torch.models import diffusion as D
from repro_torch.models import unet as U
from repro_torch.models import vae as V
from repro_torch.serving import lanes as LN
from repro_torch.serving.cache import FeatureCache, ShardedFeatureCache, prompt_signature
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.policy import ResolvedPolicy
from repro_torch.serving.scheduler import FIFOScheduler

Params = dict[str, Any]

#: a lane's first ``CACHE_MIN_STEP`` plan steps are never served from the
#: cache (the JAX engine's default ``cache_min_step``)
CACHE_MIN_STEP = 1


@dataclasses.dataclass(eq=False)  # identity semantics: queues remove by object
class GenRequest:
    """One conditioned generation request (txt2img, img2img or inpaint).

    ``timesteps`` is the executed step count.  An img2img request also
    carries ``base_timesteps`` (the untruncated schedule the stride comes
    from; ``timesteps < base_timesteps`` is a strength truncation) and
    ``init_latent`` (the known image, noised to the entry timestep at
    submission).  An inpaint request carries ``mask`` (1 = generate, 0 =
    keep ``init_latent``; blended every micro-step).
    """

    rid: int
    ctx: np.ndarray  # [ctx_len, ctx_dim] prompt embedding
    noise: np.ndarray  # [L, C] initial latent noise
    timesteps: int
    plan: PASPlan | None = None
    arrival_s: float = 0.0  # offset from stream start
    #: opt-out for quality-critical requests: never serve this request's
    #: steps from the cache (its captures may still serve other requests)
    allow_cache: bool = True
    #: per-request quality resolution; None = the engine-global threshold
    policy: ResolvedPolicy | None = None
    #: [L, C] known latent for img2img/inpaint; None = txt2img
    init_latent: np.ndarray | None = None
    #: [L] or [L, 1] inpaint mask in [0, 1] (1 = generate); None = no mask
    mask: np.ndarray | None = None
    #: untruncated schedule length; None = ``timesteps`` (no truncation)
    base_timesteps: int | None = None

    _lane_plan: LN.LanePlan | None = dataclasses.field(default=None, repr=False)
    _sig: np.ndarray | None = dataclasses.field(default=None, repr=False)
    #: [L, C] lane entry latent: the noised init of a truncated img2img
    #: request, else ``noise`` (set at submission)
    _entry: np.ndarray | None = dataclasses.field(default=None, repr=False)

    def branch_vector(self) -> np.ndarray:
        assert self._lane_plan is not None, "request not yet submitted"
        return self._lane_plan.branches[: self.timesteps]

    @property
    def sched_offset(self) -> int:
        """Schedule-truncation cache key: base minus executed steps (0 for
        the stock schedule); warm hits never cross different offsets."""
        base = self.timesteps if self.base_timesteps is None else self.base_timesteps
        return base - self.timesteps

    @property
    def quality_tier(self) -> str:
        """Resolved tier label ("full"/"pas" without a quality policy)."""
        if self.policy is not None:
            return self.policy.tier
        return "pas" if self.plan is not None else "full"

    @property
    def refine_demotions(self) -> bool:
        return self.policy is not None and self.policy.refine_demotions


@dataclasses.dataclass
class CompletedRequest:
    rid: int
    latent: np.ndarray
    image: np.ndarray | None
    submitted_s: float
    admitted_s: float
    completed_s: float

    @property
    def latency_s(self) -> float:
        return self.completed_s - self.submitted_s

    @property
    def queue_wait_s(self) -> float:
        return self.admitted_s - self.submitted_s


def _tree_device(tree) -> torch.device:
    """The device of a weight tree's first tensor."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree.device


def torch_device(device: str) -> torch.device:
    """``device`` as a torch device; raises when it is CUDA and no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def resolve_kernels(device: str, backend: str | None) -> str:
    """The kernel backend: ``backend`` if given, else "cuda" on a CUDA
    device and "eager" on the CPU."""
    if backend is not None:
        return backend
    return "cuda" if torch.device(device).type == "cuda" else "eager"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_lanes: int = 4
    max_steps: int = 64
    l_sketch: int = 3  # feature-cache geometry, engine-wide
    l_refine: int = 2
    decode_images: bool = True
    # -- feature cache (repro_torch.serving.cache) -------------------------------
    #: "off" | "intra" (hits only on the same request's slots) | "cross"
    #: (hits only on other requests' slots)
    cache_mode: str = "off"
    cache_slots: int = 16
    #: relative prompt-signature distance bound; hits need a distance
    #: strictly below it, so 0.0 never hits.  The default a request without
    #: a quality policy gets; a policy brings its own per-step thresholds.
    cache_threshold: float = 0.15
    #: timestep bucket width in train-timestep units
    cache_t_bucket: int = 125
    #: host-RAM spill ring under the device slots, in MiB: evictions demote
    #: their features there and admission promotes matches back; 0 = off
    cache_spill_mb: float = 0.0
    #: the sharded engine admits a queued request to the shard whose ring
    #: would serve its FULL steps, not to the emptiest shard
    cache_gossip: bool = True
    #: lane shards: 1 = the single-device engine; N > 1 =
    #: :class:`ShardedDiffusionEngine`, ``n_lanes / N`` lanes and
    #: ``cache_slots`` slots a shard, shard d on card d (all on the CPU
    #: with ``device="cpu"``)
    n_shards: int = 1
    #: kernel backend: "eager" (plain PyTorch) or "cuda" (the Hopper
    #: kernels); None picks "cuda" on a CUDA device and "eager" on the CPU
    backend: str | None = None
    #: torch device the engine runs on; "cuda" unless a caller asks for "cpu"
    device: str = "cuda"
    # -- construction-level fields (read by repro_torch.serving.config) -------
    unet: str = "sd_toy"
    seed: int = 0
    #: shift-score profile (.npz) refining the policy's thresholds per bucket
    profile: str | None = None
    window: int = 4  # PlanAwareScheduler alignment window
    #: default quality tier for HTTP payloads that carry none (None = the
    #: policy's own default)
    quality: str | None = None
    #: HTTP admission bound (driver-level, not an engine concern)
    max_inflight: int = 32

    def __post_init__(self):
        if self.cache_mode not in ("off", "intra", "cross"):
            raise ValueError(f"cache_mode must be off|intra|cross, got {self.cache_mode!r}")
        if self.cache_spill_mb < 0:
            raise ValueError("cache_spill_mb must be >= 0")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.n_lanes % self.n_shards != 0:
            raise ValueError(
                f"n_lanes={self.n_lanes} must divide evenly over n_shards={self.n_shards}"
            )
        if self.backend not in (None, "eager", "cuda"):
            raise ValueError(f"backend must be eager|cuda, got {self.backend!r}")
        if self.backend == "cuda" and torch.device(self.device).type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got device={self.device!r}")

    @property
    def kernels(self) -> str:
        """The resolved kernel backend."""
        return resolve_kernels(self.device, self.backend)

    def torch_device(self) -> torch.device:
        """The engine's device; raises when it is CUDA and no GPU is visible."""
        return torch_device(self.device)


class DiffusionEngine:
    #: summary tag (the driver's ``/stats`` and ``/healthz`` report it); the
    #: sharded engine overrides it
    _mode_name = "continuous"

    def __init__(
        self,
        ucfg: UNetConfig,
        dcfg: DiffusionConfig,
        params: Params,
        vae_params: Params | None = None,
        config: EngineConfig = EngineConfig(),
        scheduler: FIFOScheduler | None = None,
    ):
        n_up = U.n_up_steps(ucfg)
        if not (0 < config.l_refine <= config.l_sketch <= n_up):
            raise ValueError("engine cache geometry violates 0 < l_refine <= l_sketch <= n_up")
        self.ucfg, self.dcfg, self.config = ucfg, dcfg, config
        self.device = config.torch_device()
        self.e_sk = n_up - config.l_sketch
        self.e_rf = n_up - config.l_refine
        self.scheduler = scheduler if scheduler is not None else FIFOScheduler()
        self.metrics = ServingMetrics()

        self._build_device_state(params)  # sets cache, _state, _micro, _admit, _release
        if hasattr(self.scheduler, "attach_cache"):
            self.scheduler.attach_cache(self.cache)
        self._decoder: Callable[[torch.Tensor], torch.Tensor] | None = None
        if vae_params is not None and config.decode_images:
            lhw = (ucfg.latent_size, ucfg.latent_size)
            vae_dev = _tree_device(vae_params)
            # the decode runs where the VAE's weights are, whichever lane
            self._decoder = lambda z: V.vae_decode(
                vae_params, z.to(vae_dev), lhw, backend=config.kernels
            )

        n = config.n_lanes
        self._lane_req: list[GenRequest | None] = [None] * n
        self._lane_step = np.zeros((n,), np.int64)
        self._lane_admit_s = np.zeros((n,), np.float64)
        self._stall = np.zeros((n,), np.int64)

    def _build_device_state(self, params: Params) -> None:
        """The feature cache, the lane state and the micro-step, admit and
        release functions (the sharded engine overrides exactly this)."""
        config, ucfg = self.config, self.ucfg
        self.cache: FeatureCache | None = None
        if config.cache_mode != "off":
            self.cache = FeatureCache(
                ucfg, self.e_sk, self.e_rf,
                n_slots=config.cache_slots,
                threshold=config.cache_threshold,
                t_bucket=config.cache_t_bucket,
                mode=config.cache_mode,
                spill_mb=config.cache_spill_mb,
                device=self.device,
            )
        self._state = LN.init_lanes(
            ucfg, config.n_lanes, config.max_steps, self.e_sk, self.e_rf, self.device
        )
        self._micro = LN.make_micro_step(
            ucfg, self.dcfg, params, self.e_sk, self.e_rf,
            device=self.device, backend=config.kernels,
        )
        self._admit, self._release = LN.admit, LN.release

    # -- submission ---------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        if req.plan is not None:
            req.plan.validate(req.timesteps, U.n_up_steps(self.ucfg))
            if (req.plan.l_sketch, req.plan.l_refine) != (
                self.config.l_sketch, self.config.l_refine
            ):
                raise ValueError(
                    "request plan cache geometry (l_sketch, l_refine) = "
                    f"({req.plan.l_sketch}, {req.plan.l_refine}) does not match "
                    f"engine ({self.config.l_sketch}, {self.config.l_refine})"
                )
        if req.policy is not None and not isinstance(req.policy, ResolvedPolicy):
            raise TypeError(f"policy must be a ResolvedPolicy, got {type(req.policy).__name__}")
        threshold = (
            self.config.cache_threshold
            if req.policy is None
            else req.policy.threshold_spec(self.config.cache_threshold)
        )
        base = req.timesteps if req.base_timesteps is None else int(req.base_timesteps)
        req._lane_plan = LN.make_plan_arrays(
            self.dcfg, req.timesteps, req.plan, self.config.max_steps,
            threshold=threshold, base_timesteps=base,
        )
        L, c = req.noise.shape
        if req.mask is not None:
            m = np.asarray(req.mask, np.float32)
            if m.ndim == 1:
                m = m[:, None]
            if m.shape != (L, 1):
                raise ValueError(
                    f"mask shape {np.asarray(req.mask).shape} does not match "
                    f"latent [{L}] (want [{L}] or [{L}, 1])"
                )
            if float(m.min()) < 0.0 or float(m.max()) > 1.0:
                raise ValueError("mask values must lie in [0, 1]")
            req.mask = m
        if req.init_latent is not None and np.asarray(req.init_latent).shape != (L, c):
            raise ValueError(
                f"init latent shape {np.asarray(req.init_latent).shape} does not "
                f"match noise shape {(L, c)}"
            )
        if req.init_latent is not None and req.timesteps < base:
            # strength-truncated img2img: the lane enters mid-schedule, seeded
            # with the known image noised to the entry timestep (the same
            # q_sample the straight-line reference uses), in float32 on the host
            entry = D.q_sample(
                D.make_schedule(self.dcfg),
                torch.as_tensor(np.asarray(req.init_latent, np.float32))[None],
                torch.tensor([int(req._lane_plan.ts[0])]),
                torch.as_tensor(np.asarray(req.noise, np.float32))[None],
            )[0]
            req._entry = entry.numpy()
        else:
            req._entry = req.noise
        req._sig = prompt_signature(req.ctx)
        self.metrics.record_submission(req.quality_tier)
        self.scheduler.add(req)

    def _admit_lane(self, lane: int, req: GenRequest, now_s: float) -> None:
        """Scatter ``req`` into the empty ``lane``, its tensors on the lane's
        device.  An inpaint request brings (mask, x_init, noise0); any other
        takes the all-ones mask, the identity."""
        dev = self._lane_device(lane)
        to = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        extras = (None, None, None)
        if req.mask is not None:
            x_init = req.init_latent
            if x_init is None:
                x_init = np.zeros(req.noise.shape, np.float32)
            extras = (to(req.mask), to(x_init), to(req.noise))
        self._admit(self._state, lane, to(req._entry), to(req.ctx), req._lane_plan, *extras)
        self._lane_req[lane] = req
        self._lane_step[lane] = 0
        self._lane_admit_s[lane] = now_s
        self._stall[lane] = 0

    def _lane_device(self, lane: int) -> torch.device:
        return self.device

    def _lane_latent(self, lane: int) -> torch.Tensor:
        return self._state.x[lane]

    def _ring_of(self, lane: int) -> tuple:
        """The leading cache arguments that name a lane's ring: none here,
        the shard on the sharded engine."""
        return ()

    # -- introspection ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._lane_req)

    @property
    def n_pending(self) -> int:
        return len(self.scheduler)

    def progress(self) -> list[tuple[int, int, int]]:
        """``(rid, completed steps, total steps)`` per in-flight lane."""
        return [
            (r.rid, int(self._lane_step[i]), r.timesteps)
            for i, r in enumerate(self._lane_req)
            if r is not None
        ]

    # -- cancellation -------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Abort one request wherever it is: a queued request leaves the
        admission queue; an in-flight request's lane is released at once, so
        the next :meth:`step` can backfill it.  False when the rid is
        unknown here (completed, never submitted, or cancelled before)."""
        if self.scheduler.remove(rid):
            return True
        for lane, req in enumerate(self._lane_req):
            if req is not None and req.rid == rid:
                self._release_lane(lane)
                self._lane_req[lane] = None
                self._stall[lane] = 0
                return True
        return False

    def _release_lane(self, lane: int) -> None:
        """Mark a lane empty on its device (host mirrors are the caller's)."""
        self._release(self._state, lane)

    def _active_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self._lane_req) if r is not None]

    def _remaining_branches(self) -> list[np.ndarray]:
        return [
            self._lane_req[i]._lane_plan.branches[self._lane_step[i] : self._lane_req[i].timesteps]
            for i in self._active_lanes()
        ]

    # -- event loop ---------------------------------------------------------

    def _prefetch_spill(self, req: GenRequest, shard: int | None = None) -> None:
        """Admission-time spill prefetch: for each planned FULL step of the
        request that no device slot would serve yet, probe the host spill
        ring and promote a match onto the device ring (shard ``shard``'s on
        the sharded engine), so the lane's first planned FULL step finds it
        there.  Threshold-0 steps never probe."""
        cache = self.cache
        if cache is None or cache.spill is None or not req.allow_cache:
            return
        at = () if shard is None else (shard,)
        lp, sig, off = req._lane_plan, req._sig, req.sched_offset
        for i in range(lp.n_steps):
            if lp.branches[i] != SM.FULL or i < CACHE_MIN_STEP:
                continue
            thr = float(lp.thr[i])
            if thr <= 0:
                continue
            t = int(lp.ts[i])
            if cache.probe(*at, t, sig, req.rid, thr, off) is not None:
                continue  # already warm on the device ring
            if cache.promote(*at, t, sig, req.rid, thr, off) is not None:
                self.metrics.spill_promotions += 1

    def _backfill(self, now_s: float) -> None:
        for lane, holder in enumerate(self._lane_req):
            if holder is not None:
                continue
            req = self.scheduler.next_request(self._remaining_branches())
            if req is None:
                return
            self._prefetch_spill(req)
            self._admit_lane(lane, req, now_s)

    def _probe_eligible(self, req: GenRequest, lane: int, planned: int) -> bool:
        """Whether a lane's next planned step may be served from the cache:
        planned FULL steps always probe; planned SKETCH steps only when the
        request's quality policy opted into SKETCH->REFINE demotions; never
        for a request that opted out of the cache."""
        if not req.allow_cache or self._lane_step[lane] < CACHE_MIN_STEP:
            return False
        if planned == SM.FULL:
            return True
        return planned == SM.SKETCH and req.refine_demotions

    def _probe_cache(
        self, active: list[int], planned: np.ndarray
    ) -> dict[int, tuple[int, float]]:
        """{lane: (slot, signature distance)} for the active lanes whose next
        planned step a warm slot could serve, each probed at the request's
        own per-step threshold.  Read-only: counters and LRU touches settle
        in :meth:`step` for the lanes that actually advance."""
        hits: dict[int, tuple[int, float]] = {}
        if self.cache is None:
            return hits
        for k, lane in enumerate(active):
            req = self._lane_req[lane]
            if not self._probe_eligible(req, lane, int(planned[k])):
                continue
            step = self._lane_step[lane]
            hit = self.cache.probe_distance(
                *self._ring_of(lane), int(req._lane_plan.ts[step]), req._sig, req.rid,
                float(req._lane_plan.thr[step]), req.sched_offset,
            )
            if hit is not None:
                hits[lane] = hit
        return hits

    def _vote_inputs(self, active: list[int]):
        """(planned class by lane, warm-slot hits, effective classes) of the
        active lanes.  Cache demotion: a planned FULL step with a warm slot
        runs as SKETCH on the slot's features; a planned SKETCH step whose
        policy allows it as REFINE.  The vote is over the effective classes."""
        planned = np.array(
            [self._lane_req[i]._lane_plan.branches[self._lane_step[i]] for i in active], np.int64
        )
        hit_slots = self._probe_cache(active, planned)
        planned_of = {int(lane): int(planned[k]) for k, lane in enumerate(active)}
        effective = planned.copy()
        for k, lane in enumerate(active):
            if lane in hit_slots:
                effective[k] = SM.SKETCH if planned[k] == SM.FULL else SM.REFINE
        return planned_of, hit_slots, effective

    def _settle_partial(self, advanced, planned_of, hit_slots, feat_src, feat_dist, ring=()):
        """Accounting of the lanes a SKETCH or REFINE vote advances, on
        ring ``ring``: each hit writes its slot and distance into
        ``feat_src`` / ``feat_dist`` and counts; a planned partial step that
        probed and missed counts a miss.  Returns (FULL->SKETCH,
        SKETCH->REFINE) demotions."""
        n_demoted = n_demoted_rf = 0
        for lane in advanced:
            hit = hit_slots.get(int(lane))
            if hit is None:
                if self._probe_eligible(self._lane_req[lane], int(lane), planned_of[int(lane)]):
                    self.cache.note_miss(*ring)
                continue
            slot, dist = hit
            feat_src[lane] = slot
            feat_dist[lane] = dist
            self.cache.note_hit(*ring, slot)
            if planned_of[int(lane)] == SM.FULL:
                n_demoted += 1
            else:
                n_demoted_rf += 1
        return n_demoted, n_demoted_rf

    def _capture_slot(self, lane: int, taken: set[int], ring=()) -> int | None:
        """After a FULL micro-step: count the lane's probed FULL step as a
        miss and reserve a slot on ring ``ring`` for its fresh capture,
        conflict-free with ``taken`` (which it joins); None when the ring is
        smaller than the FULL batch, or when only this request could
        consume the capture (``intra``) and it opted out."""
        req = self._lane_req[lane]
        step = self._lane_step[lane]
        if req.allow_cache and step >= CACHE_MIN_STEP:
            self.cache.note_miss(*ring)  # probed FULL executed as FULL
        if self.config.cache_mode == "intra" and not req.allow_cache:
            return None
        slot = self.cache.reserve(
            *ring, int(req._lane_plan.ts[step]), req._sig, req.rid, exclude=taken,
            offset=req.sched_offset,
        )
        if slot is not None:
            taken.add(slot)
        return slot

    def _reserve_captures(self, advanced: np.ndarray) -> None:
        """Reserve a slot for each fresh capture on the host, then fill them
        all in one indexed copy from the lane caches the micro-step just
        wrote."""
        n = self.config.n_lanes
        lanes = np.zeros((n,), np.int64)
        slots = np.full((n,), self.cache.n_slots, np.int64)  # padding: dropped
        taken: set[int] = set()
        for k, lane in enumerate(advanced):
            slot = self._capture_slot(int(lane), taken)
            if slot is not None:
                lanes[k] = int(lane)
                slots[k] = slot
        if taken:
            self.cache.insert_many(self._state.f_sk, self._state.f_rf, lanes, slots)

    def step(
        self, now_s: float = 0.0, clock: Callable[[], float] | None = None
    ) -> list[CompletedRequest]:
        """Backfill, run one micro-step, retire finished lanes.

        ``clock`` (same origin as ``now_s``) re-reads the time after the
        retirement sync, so completion stamps include the queued device work.
        While a profiler collects, each phase runs in its range
        (:mod:`repro_torch.common.trace`): ``engine.backfill``, ``vote``,
        ``upload`` (the advance mask and cache vectors to the device, which
        blocks until the queued micro-steps finish), ``dispatch`` and
        ``retire``.
        """
        with T.phase("engine.backfill"):
            self._backfill(now_s)
        active = self._active_lanes()
        if not active:
            return []
        t_step0 = time.perf_counter()

        with T.phase("engine.vote"):
            planned_of, hit_slots, effective = self._vote_inputs(active)
            b_star = self.scheduler.pick_branch(effective, self._stall[active])

            # the advance mask follows from the host-known plans and cache keys:
            # no device sync
            n = self.config.n_lanes
            sel = np.zeros((n,), bool)
            advanced = np.asarray(active)[effective == b_star]
            sel[advanced] = True
            n_demoted = n_demoted_rf = 0
            if self.cache is not None:
                feat_src = np.full((n,), -1, np.int64)
                # float32, as the JAX engine ships it: the device compares this
                # distance strictly against the lane's float32 threshold
                feat_dist = np.full((n,), np.inf, np.float32)
                if b_star in (SM.SKETCH, SM.REFINE):
                    n_demoted, n_demoted_rf = self._settle_partial(
                        advanced, planned_of, hit_slots, feat_src, feat_dist)
        t_wait = time.perf_counter()
        with T.phase("engine.upload"):
            sel_t = torch.from_numpy(sel).to(self.device)
            cache_args = () if self.cache is None else (
                torch.from_numpy(feat_src).to(self.device),
                torch.from_numpy(feat_dist).to(self.device),
                self.cache.state,
            )
        self.metrics.record_wait(time.perf_counter() - t_wait)
        n_adv = len(advanced)
        with T.phase("engine.dispatch"):
            self._micro(self._state, b_star, sel_t, *cache_args, n_advanced=n_adv)
            if self.cache is not None and b_star == SM.FULL:
                self._reserve_captures(advanced)

        self._lane_step[sel] += 1
        self._stall[active] += 1
        self._stall[sel] = 0
        self.metrics.record_step(
            n, len(active), n_adv,
            n_full=n_adv if b_star == SM.FULL else 0,
            n_sketch=n_adv if b_star == SM.SKETCH else 0,
            n_refine=n_adv if b_star == SM.REFINE else 0,
            n_demoted=n_demoted, n_demoted_refine=n_demoted_rf,
        )
        with T.phase("engine.retire"):
            done = self._retire(active, now_s, clock)
        self.metrics.record_step_time(self.config.kernels, time.perf_counter() - t_step0)
        return done

    def _retire(
        self, active: list[int], now_s: float, clock: Callable[[], float] | None
    ) -> list[CompletedRequest]:
        """Decode and release every active lane whose schedule has ended."""
        done: list[CompletedRequest] = []
        for lane in active:
            req = self._lane_req[lane]
            if self._lane_step[lane] < req.timesteps:
                continue
            latent = self._lane_latent(lane).clone()
            image = None
            if self._decoder is not None:
                image = self._decoder(latent[None])[0]
            t_wait = time.perf_counter()
            # the first copy to the host waits for the queued micro-steps and the decode
            image = None if image is None else image.cpu().numpy()
            latent = latent.cpu().numpy()
            self.metrics.record_wait(time.perf_counter() - t_wait)
            done.append(
                CompletedRequest(
                    rid=req.rid,
                    latent=latent,
                    image=image,
                    submitted_s=req.arrival_s,
                    admitted_s=self._lane_admit_s[lane],
                    completed_s=clock() if clock is not None else now_s,
                )
            )
            self._release_lane(lane)
            self._lane_req[lane] = None
            self.metrics.record_completion(done[-1].latency_s, done[-1].queue_wait_s)
        return done

    def run(self, requests: Sequence[GenRequest]) -> tuple[list[CompletedRequest], dict]:
        """Serve a request stream to completion, every request queued up
        front in arrival order.  Metrics and the feature cache reset per
        call, so ``run`` output is a function of the stream (drive
        :meth:`step` directly to keep warmth across calls).
        """
        self.metrics = ServingMetrics()
        if self.cache is not None:
            self.cache.reset()
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0  # noqa: E731
        done: list[CompletedRequest] = []
        for req in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(req)
        while self.n_pending or self.n_active:
            done.extend(self.step(now_s=clock(), clock=clock))
        self.metrics.wall_s = time.perf_counter() - t0
        summary = dict(
            self.metrics.summary(),
            mode=self._mode_name,
            lanes=self.config.n_lanes,
            kernels=self.config.kernels,
            device=str(self.device),
            **self._summary_extra(),
        )
        if self.cache is not None:
            summary.update(self.cache.stats())
        return done, summary

    def _summary_extra(self) -> dict:
        return {}


class ShardedDiffusionEngine(DiffusionEngine):
    """Continuous batching with the lanes in shards, one shard a device.

    Shard ``d`` owns lanes ``[d * P, (d + 1) * P)`` (``P = n_lanes /
    n_shards``) on ``devices[d]``: by default card ``d`` (all ``cpu`` with
    ``device="cpu"``), or an explicit list, where shards may share a card.
    The U-Net weights are held once per distinct device.  The branch vote
    is per shard: each shard runs its own class, so one shard can run a
    FULL batch while another runs SKETCH, and a shard with no active lane
    is parked on REFINE under an all-false mask.  Admission fills the
    emptiest shard, or, with ``cache_gossip``, the shard whose ring would
    serve a queued request's FULL steps (counted in ``gossip_routed``).
    The feature cache is a :class:`~repro_torch.serving.cache.ShardedFeatureCache`:
    probes, hits and inserts stay on the lane's own shard; only the shared
    spill ring carries features across shards.

    ``n_shards=1`` on the engine's device runs the single-device engine's
    micro-steps on the same batches in the same order, so its latents are
    bit for bit :class:`DiffusionEngine`'s; :func:`make_serving_engine`
    picks :class:`DiffusionEngine` itself at one shard.
    """

    _mode_name = "sharded-continuous"

    def __init__(
        self,
        ucfg: UNetConfig,
        dcfg: DiffusionConfig,
        params: Params,
        vae_params: Params | None = None,
        config: EngineConfig = EngineConfig(),
        scheduler: FIFOScheduler | None = None,
        devices: Sequence | None = None,
    ):
        self._devices_arg = devices
        super().__init__(ucfg, dcfg, params, vae_params, config, scheduler=scheduler)

    def _build_device_state(self, params: Params) -> None:
        config, ucfg = self.config, self.ucfg
        devices = self._devices_arg
        if devices is None:
            devices = lane_devices(config.n_shards, config.device)
        self.devices = [resolve_device(d) for d in devices]
        if len(self.devices) != config.n_shards:
            raise ValueError(
                f"{len(self.devices)} shard devices but config.n_shards={config.n_shards}"
            )
        self.n_shards = config.n_shards
        self.lanes_per_shard = config.n_lanes // self.n_shards
        home = _tree_device(params)
        #: the U-Net weights on each distinct device (the caller's own tree
        #: where it already lies, so its uniconv weight preparation is shared)
        self._params_on = {
            dev: params if dev == home else tree_map(lambda t, d=dev: t.to(d), params)
            for dev in dict.fromkeys(self.devices)
        }
        self.cache: ShardedFeatureCache | None = None
        if config.cache_mode != "off":
            self.cache = ShardedFeatureCache(
                ucfg, self.e_sk, self.e_rf, self.devices,
                slots_per_shard=config.cache_slots,
                threshold=config.cache_threshold,
                t_bucket=config.cache_t_bucket,
                mode=config.cache_mode,
                spill_mb=config.cache_spill_mb,
            )
        self._state = LN.init_sharded_lanes(
            ucfg, config.n_lanes, config.max_steps, self.e_sk, self.e_rf, self.devices
        )
        self._micro = LN.make_sharded_micro_step(
            ucfg, self.dcfg, self._params_on, self.e_sk, self.e_rf, self.devices,
            backend=config.kernels,
        )
        self._admit = LN.make_sharded_admit()
        self._release = LN.make_sharded_release()

    # -- shard geometry -------------------------------------------------------

    def _shard_of(self, lane: int) -> int:
        return int(lane) // self.lanes_per_shard

    def _lane_device(self, lane: int) -> torch.device:
        return self.devices[self._shard_of(lane)]

    def _lane_latent(self, lane: int) -> torch.Tensor:
        s, i = self._state.locate(lane)
        return self._state.shards[s].x[i]

    def _ring_of(self, lane: int) -> tuple:
        return (self._shard_of(lane),)

    def _shard_active_counts(self) -> list[int]:
        counts = [0] * self.n_shards
        for lane in self._active_lanes():
            counts[self._shard_of(lane)] += 1
        return counts

    def _shard_remaining_branches(self, shard: int) -> list[np.ndarray]:
        """Remaining branch vectors of the shard's own in-flight lanes: the
        alignment scope of admission, since the vote is per shard."""
        lo = shard * self.lanes_per_shard
        return [
            self._lane_req[i]._lane_plan.branches[self._lane_step[i] : self._lane_req[i].timesteps]
            for i in range(lo, lo + self.lanes_per_shard)
            if self._lane_req[i] is not None
        ]

    def _summary_extra(self) -> dict:
        return {
            "shards": self.n_shards,
            "lanes_per_shard": self.lanes_per_shard,
            "devices": [str(d) for d in self.devices],
        }

    # -- event loop -----------------------------------------------------------

    def _backfill(self, now_s: float) -> None:
        """Admit queued requests, each into the lowest empty lane of the
        emptiest shard, re-ranked at every admission so a burst spreads;
        with ``cache_gossip``, into the shard the scheduler's warmth map
        names instead, when it has a free lane."""
        while True:
            empty = [i for i, r in enumerate(self._lane_req) if r is None]
            if not empty:
                return
            counts = self._shard_active_counts()
            lane = min(empty, key=lambda i: (counts[self._shard_of(i)], i))
            shard = self._shard_of(lane)
            if self.config.cache_gossip and hasattr(self.scheduler, "peek_warm_shard"):
                warm = self.scheduler.peek_warm_shard(sorted({self._shard_of(i) for i in empty}))
                if warm is not None and warm != shard:
                    lane = min(i for i in empty if self._shard_of(i) == warm)
                    shard = warm
                    self.metrics.gossip_routed += 1
            req = self.scheduler.next_request(self._shard_remaining_branches(shard), shard=shard)
            if req is None:
                return
            self._prefetch_spill(req, shard)
            self._admit_lane(lane, req, now_s)

    def step(
        self, now_s: float = 0.0, clock: Callable[[], float] | None = None
    ) -> list[CompletedRequest]:
        """Backfill, run one micro-step on every shard with an active lane,
        each in its own shard's vote, retire finished lanes.  A lane
        advances when its effective class is its shard's vote.  The phase
        ranges are the single-device engine's, but for ``upload``: each
        shard's vectors go to its device inside ``dispatch``."""
        with T.phase("engine.backfill"):
            self._backfill(now_s)
        active = self._active_lanes()
        if not active:
            return []
        t_step0 = time.perf_counter()

        with T.phase("engine.vote"):
            planned_of, hit_slots, effective = self._vote_inputs(active)
            n = self.config.n_lanes
            active_arr = np.asarray(active)
            shard_ids = active_arr // self.lanes_per_shard
            b_arr = np.full((self.n_shards,), SM.REFINE, np.int64)  # idle shards: the cheapest
            sel = np.zeros((n,), bool)
            votes: list[tuple[int, int, np.ndarray]] = []  # (shard, class, advanced lanes)
            for s in range(self.n_shards):
                mine = shard_ids == s
                if not mine.any():
                    continue
                lanes_s = active_arr[mine]
                b = self.scheduler.pick_branch(effective[mine], self._stall[lanes_s])
                b_arr[s] = b
                adv = lanes_s[effective[mine] == b]
                sel[adv] = True
                votes.append((s, b, adv))

            n_demoted = n_demoted_rf = 0
            if self.cache is not None:
                feat_src = np.full((n,), -1, np.int64)
                feat_dist = np.full((n,), np.inf, np.float32)
                for s, b, adv in votes:
                    if b != SM.FULL:
                        d, r = self._settle_partial(
                            adv, planned_of, hit_slots, feat_src, feat_dist, ring=(s,))
                        n_demoted += d
                        n_demoted_rf += r
        with T.phase("engine.dispatch"):
            if self.cache is not None:
                self._micro(self._state, b_arr, sel, feat_src, feat_dist, self.cache.state)
                self._reserve_shard_captures(votes)
            else:
                self._micro(self._state, b_arr, sel)

        self._lane_step[sel] += 1
        self._stall[active] += 1
        self._stall[sel] = 0
        by_class = {
            b: sum(len(adv) for _, bb, adv in votes if bb == b)
            for b in (SM.FULL, SM.SKETCH, SM.REFINE)
        }
        self.metrics.record_step(
            n, len(active), int(sel.sum()),
            n_full=by_class[SM.FULL], n_sketch=by_class[SM.SKETCH],
            n_refine=by_class[SM.REFINE],
            n_demoted=n_demoted, n_demoted_refine=n_demoted_rf,
            shard_active=[int((shard_ids == s).sum()) for s in range(self.n_shards)],
        )
        with T.phase("engine.retire"):
            done = self._retire(active, now_s, clock)
        self.metrics.record_step_time(self.config.kernels, time.perf_counter() - t_step0)
        return done

    def _reserve_shard_captures(self, votes) -> None:
        """After the shards' FULL votes: reserve each fresh capture a slot on
        its own shard's ring, then fill them with one indexed copy a shard.
        The index arrays hold shard-local lanes and slots in per-shard
        segments (``ShardedFeatureCache.insert_many``)."""
        n = self.config.n_lanes
        lanes = np.zeros((n,), np.int64)
        slots = np.full((n,), self.cache.slots_per_shard, np.int64)  # padding: dropped
        any_insert = False
        for s, b, adv in votes:
            if b != SM.FULL:
                continue
            base = pos = s * self.lanes_per_shard
            taken: set[int] = set()
            for lane in adv:
                slot = self._capture_slot(int(lane), taken, ring=(s,))
                if slot is None:
                    continue
                lanes[pos] = int(lane) - base
                slots[pos] = slot
                pos += 1
                any_insert = True
        if any_insert:
            shards = self._state.shards
            self.cache.insert_many(
                [sh.f_sk for sh in shards], [sh.f_rf for sh in shards], lanes, slots)


def make_serving_engine(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params: Params,
    vae_params: Params | None = None,
    config: EngineConfig = EngineConfig(),
    scheduler: FIFOScheduler | None = None,
) -> DiffusionEngine:
    """The engine for ``config.n_shards``: :class:`DiffusionEngine` at 1,
    :class:`ShardedDiffusionEngine` above."""
    cls = ShardedDiffusionEngine if config.n_shards > 1 else DiffusionEngine
    return cls(ucfg, dcfg, params, vae_params, config, scheduler=scheduler)


class StaticServer:
    """Fixed-size FIFO batches running the PAS sampler in lockstep: the
    baseline continuous batching is measured against.

    The whole batch runs ``max(timesteps)`` of its members with the plan
    ``plan_fn`` gives that count, and short batches are padded by repeating
    the last request.
    ``idle_lane_frac`` in the summary is the share of lane-steps spent on
    padding or lockstep overshoot.
    """

    def __init__(
        self,
        ucfg: UNetConfig,
        dcfg: DiffusionConfig,
        params: Params,
        vae_params: Params | None,
        batch: int,
        *,
        plan_fn: Callable[[int], PASPlan | None] = lambda t: None,
        decode_images: bool = True,
        backend: str | None = None,
        device: str = "cuda",
    ):
        self.ucfg, self.dcfg, self.params, self.batch = ucfg, dcfg, params, batch
        self.plan_fn = plan_fn
        self.device = torch_device(device)
        self.kernels = resolve_kernels(device, backend)
        self.vae_params = vae_params if decode_images else None

    def _generate(self, total_steps: int, noise: torch.Tensor, ctx: torch.Tensor):
        d = dataclasses.replace(self.dcfg, timesteps_sample=total_steps)
        x0 = SM.pas_denoise(
            self.ucfg, d, self.params, self.plan_fn(total_steps), noise, ctx,
            torch.zeros_like(ctx), backend=self.kernels,
        )
        if self.vae_params is None:
            return x0, None
        lhw = (self.ucfg.latent_size, self.ucfg.latent_size)
        return x0, V.vae_decode(self.vae_params, x0, lhw, backend=self.kernels)

    def _dummy_inputs(self):
        L = self.ucfg.latent_size**2
        noise = torch.zeros((self.batch, L, self.ucfg.in_channels), device=self.device)
        ctx = torch.zeros((self.batch, self.ucfg.ctx_len, self.ucfg.ctx_dim), device=self.device)
        return noise, ctx

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, timesteps: Sequence[int]) -> None:
        """Run the lockstep sampler once for every listed step count (the
        kernels build and the weights are prepared on the first call)."""
        noise, ctx = self._dummy_inputs()
        for t in timesteps:
            self._generate(t, noise, ctx)
        self._sync()

    def time_step_s(self, timesteps: int, iters: int = 3) -> float:
        """Median per-denoise-step wall seconds of the lockstep sampler,
        each call synchronised with the card."""
        noise, ctx = self._dummy_inputs()
        self._generate(timesteps, noise, ctx)
        self._sync()
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self._generate(timesteps, noise, ctx)
            self._sync()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[len(walls) // 2] / timesteps

    def run(self, requests: Sequence[GenRequest]) -> tuple[list[CompletedRequest], dict]:
        """Serve a request stream in arrival order, one lockstep batch at a time."""
        batch = self.batch
        pending = sorted(requests, key=lambda r: r.arrival_s)
        metrics = ServingMetrics()
        done: list[CompletedRequest] = []
        total_lane_steps = useful_lane_steps = 0
        t0 = time.perf_counter()
        for i in range(0, len(pending), batch):
            group = pending[i : i + batch]
            admit_s = time.perf_counter() - t0
            t_max = max(r.timesteps for r in group)
            pad = batch - len(group)
            as_t = lambda arrs: torch.as_tensor(np.stack(arrs), dtype=torch.float32)  # noqa: E731
            noise = as_t([r.noise for r in group] + [group[-1].noise] * pad).to(self.device)
            ctx = as_t([r.ctx for r in group] + [group[-1].ctx] * pad).to(self.device)
            x0, imgs = self._generate(t_max, noise, ctx)
            x0 = x0.cpu().numpy()  # syncs the batch
            imgs = None if imgs is None else imgs.cpu().numpy()
            now = time.perf_counter() - t0
            total_lane_steps += batch * t_max
            useful_lane_steps += sum(r.timesteps for r in group)
            for _ in range(t_max):
                metrics.record_step(batch, len(group), len(group))
            for lane, req in enumerate(group):
                done.append(
                    CompletedRequest(
                        rid=req.rid,
                        latent=x0[lane],
                        image=None if imgs is None else imgs[lane],
                        submitted_s=req.arrival_s,
                        admitted_s=admit_s,
                        completed_s=now,
                    )
                )
                metrics.record_completion(done[-1].latency_s, done[-1].queue_wait_s)
        metrics.wall_s = time.perf_counter() - t0
        idle = 1.0 - useful_lane_steps / max(total_lane_steps, 1)
        summary = dict(
            metrics.summary(),
            mode="static",
            lanes=batch,
            idle_lane_frac=round(idle, 3),
            kernels=self.kernels,
            device=str(self.device),
        )
        return done, summary


def serve_static(
    ucfg: UNetConfig,
    dcfg: DiffusionConfig,
    params: Params,
    vae_params: Params | None,
    requests: Sequence[GenRequest],
    batch: int,
    *,
    plan_fn: Callable[[int], PASPlan | None] = lambda t: None,
    decode_images: bool = True,
    backend: str | None = None,
    device: str = "cuda",
) -> tuple[list[CompletedRequest], dict]:
    """One-shot convenience wrapper around :class:`StaticServer`."""
    server = StaticServer(
        ucfg, dcfg, params, vae_params, batch,
        plan_fn=plan_fn, decode_images=decode_images, backend=backend, device=device,
    )
    return server.run(requests)
