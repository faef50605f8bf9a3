"""Continuous-batching diffusion serving engine, single device, cache off.

Port of ``repro/serving/engine.py::DiffusionEngine``.  The engine advances a
fixed set of *lanes* through the PAS denoise loop one micro-step at a time.
Lanes hold requests at different denoise steps; each micro-step runs one
branch class (FULL / SKETCH / REFINE), chosen by the packing policy, as one
batched U-Net call.  A lane retires through the VAE decoder the moment its
own schedule ends and is backfilled from the admission queue at once.

Not ported yet, and refused with ``ValueError``: the feature cache
(``cache_mode`` other than "off"), the sharded engine (``n_shards > 1``),
and requests carrying ``mask``, ``init_latent``, ``base_timesteps`` or
``policy`` (inpaint, img2img, the quality policy).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.common.types import DiffusionConfig, PASPlan, UNetConfig
from repro_torch.core import sampler as SM
from repro_torch.models import unet as U
from repro_torch.models import vae as V
from repro_torch.serving import lanes as LN
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import FIFOScheduler

Params = dict[str, Any]


@dataclasses.dataclass(eq=False)  # identity semantics: queues remove by object
class GenRequest:
    """One txt2img generation request."""

    rid: int
    ctx: np.ndarray  # [ctx_len, ctx_dim] prompt embedding
    noise: np.ndarray  # [L, C] initial latent noise
    timesteps: int
    plan: PASPlan | None = None
    arrival_s: float = 0.0  # offset from stream start
    # the JAX request's conditioned-task fields; not ported yet, refused at submit
    policy: Any = None
    init_latent: np.ndarray | None = None
    mask: np.ndarray | None = None
    base_timesteps: int | None = None

    _lane_plan: LN.LanePlan | None = dataclasses.field(default=None, repr=False)

    def branch_vector(self) -> np.ndarray:
        assert self._lane_plan is not None, "request not yet submitted"
        return self._lane_plan.branches[: self.timesteps]


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


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not yet ported to repro_torch")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_lanes: int = 4
    max_steps: int = 64
    l_sketch: int = 3  # cache geometry of the PAS plans (see repro's engine)
    l_refine: int = 2
    decode_images: bool = True
    cache_mode: str = "off"
    n_shards: int = 1
    #: kernel backend: "eager" (plain PyTorch) or "cuda" (the Hopper
    #: kernels); None picks "cuda" on a CUDA device and "eager" on the CPU
    backend: str | None = None
    #: torch device the engine runs on; "cuda" unless a caller asks for "cpu"
    device: str = "cuda"
    # -- construction-level fields (read by repro_torch.serving.config) -------
    unet: str = "sd_toy"
    seed: int = 0
    window: int = 4  # PlanAwareScheduler alignment window

    def __post_init__(self):
        if self.cache_mode != "off":
            raise _not_ported(f"cache_mode={self.cache_mode!r} (the feature cache)")
        if self.n_shards != 1:
            raise _not_ported(f"n_shards={self.n_shards} (the sharded engine)")
        if self.backend not in (None, "eager", "cuda"):
            raise ValueError(f"backend must be eager|cuda, got {self.backend!r}")
        if self.backend == "cuda" and torch.device(self.device).type != "cuda":
            raise ValueError(f"backend 'cuda' needs a CUDA device, got device={self.device!r}")

    @property
    def kernels(self) -> str:
        """The resolved kernel backend."""
        if self.backend is not None:
            return self.backend
        return "cuda" if torch.device(self.device).type == "cuda" else "eager"

    def torch_device(self) -> torch.device:
        """The engine's device; raises when it is CUDA and no GPU is visible."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        return dev


class DiffusionEngine:
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

        self._state = LN.init_lanes(
            ucfg, config.n_lanes, config.max_steps, self.e_sk, self.e_rf, self.device
        )
        self._micro = LN.make_micro_step(
            ucfg, dcfg, params, self.e_sk, self.e_rf,
            device=self.device, backend=config.kernels,
        )
        self._decoder: Callable[[torch.Tensor], torch.Tensor] | None = None
        if vae_params is not None and config.decode_images:
            lhw = (ucfg.latent_size, ucfg.latent_size)
            self._decoder = lambda z: V.vae_decode(vae_params, z, lhw, backend=config.kernels)

        n = config.n_lanes
        self._lane_req: list[GenRequest | None] = [None] * n
        self._lane_step = np.zeros((n,), np.int64)
        self._lane_admit_s = np.zeros((n,), np.float64)
        self._stall = np.zeros((n,), np.int64)

    # -- submission ---------------------------------------------------------

    def submit(self, req: GenRequest) -> None:
        for field in ("mask", "init_latent", "policy"):
            if getattr(req, field) is not None:
                raise _not_ported(f"a request carrying {field!r}")
        if req.base_timesteps not in (None, req.timesteps):
            raise _not_ported("a strength-truncated (img2img) request")
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
        req._lane_plan = LN.make_plan_arrays(
            self.dcfg, req.timesteps, req.plan, self.config.max_steps
        )
        self.scheduler.add(req)

    # -- introspection ------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._lane_req)

    @property
    def n_pending(self) -> int:
        return len(self.scheduler)

    def _active_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self._lane_req) if r is not None]

    # -- event loop ---------------------------------------------------------

    def _backfill(self, now_s: float) -> None:
        for lane, holder in enumerate(self._lane_req):
            if holder is not None:
                continue
            remaining = [
                r._lane_plan.branches[self._lane_step[i] : r.timesteps]
                for i, r in enumerate(self._lane_req)
                if r is not None
            ]
            req = self.scheduler.next_request(remaining)
            if req is None:
                return
            LN.admit(
                self._state, lane,
                torch.as_tensor(req.noise, dtype=torch.float32).to(self.device),
                torch.as_tensor(req.ctx, dtype=torch.float32).to(self.device),
                req._lane_plan,
            )
            self._lane_req[lane] = req
            self._lane_step[lane] = 0
            self._lane_admit_s[lane] = now_s
            self._stall[lane] = 0

    def step(
        self, now_s: float = 0.0, clock: Callable[[], float] | None = None
    ) -> list[CompletedRequest]:
        """Backfill, run one micro-step, retire finished lanes."""
        self._backfill(now_s)
        active = self._active_lanes()
        if not active:
            return []
        t_step0 = time.perf_counter()

        planned = np.array(
            [self._lane_req[i]._lane_plan.branches[self._lane_step[i]] for i in active], np.int64
        )
        b_star = self.scheduler.pick_branch(planned, self._stall[active])
        # the advance mask follows from the host-known plans: no device sync
        sel = np.zeros((self.config.n_lanes,), bool)
        advanced = np.asarray(active)[planned == b_star]
        sel[advanced] = True
        self._micro(self._state, b_star, torch.from_numpy(sel).to(self.device))

        self._lane_step[sel] += 1
        self._stall[active] += 1
        self._stall[sel] = 0
        n_adv = len(advanced)
        self.metrics.record_step(
            self.config.n_lanes, len(active), n_adv,
            n_full=n_adv if b_star == SM.FULL else 0,
            n_sketch=n_adv if b_star == SM.SKETCH else 0,
            n_refine=n_adv if b_star == SM.REFINE else 0,
        )

        done: list[CompletedRequest] = []
        for lane in active:
            req = self._lane_req[lane]
            if self._lane_step[lane] < req.timesteps:
                continue
            latent = self._state.x[lane].clone()
            image = None
            if self._decoder is not None:
                image = self._decoder(latent[None])[0].cpu().numpy()
            latent = latent.cpu().numpy()  # syncs the queued micro-steps
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
            LN.release(self._state, lane)
            self._lane_req[lane] = None
            self.metrics.record_completion(done[-1].latency_s, done[-1].queue_wait_s)
        self.metrics.record_step_time(self.config.kernels, time.perf_counter() - t_step0)
        return done

    def run(self, requests: Sequence[GenRequest]) -> tuple[list[CompletedRequest], dict]:
        """Serve a request stream to completion, every request queued up
        front (arrival offsets are not replayed).  Metrics reset per call."""
        self.metrics = ServingMetrics()
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0  # noqa: E731
        for req in sorted(requests, key=lambda r: r.arrival_s):
            self.submit(req)
        done: list[CompletedRequest] = []
        while self.n_pending or self.n_active:
            done.extend(self.step(now_s=clock(), clock=clock))
        self.metrics.wall_s = time.perf_counter() - t0
        summary = dict(
            self.metrics.summary(),
            mode="continuous",
            lanes=self.config.n_lanes,
            kernels=self.config.kernels,
            device=str(self.device),
        )
        return done, summary
