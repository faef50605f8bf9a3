"""One run of one cell on the served path, without HTTP.

``serving/config.py::build_engine`` builds the engine on weights the
benchmark makes from the seed; ``serving/driver.py::EngineDriver`` runs it
on its own thread; the benchmark submits requests through
``EngineDriver.submit``, from the driver's event callbacks (a backlog) or
from a generator thread at due times (open loop), and records every event
with the host's clock.  The window opens and closes between two
``engine.step`` calls, on the driver's thread, where the program's
counters are read and, in a traced run, the profiler starts and stops.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
import types
from typing import Any

from bench import flops
from bench.reference.weights import make_weights
from bench.traffic import Traffic

#: engine counters read at the window's edges (``ServingMetrics`` fields)
COUNTERS = ("micro_steps", "lane_steps_advanced")
#: how long the fill may take before the window opens, and the driver to
#: drain once the run's requests are cancelled
FILL_LIMIT_S = 240.0
SHUTDOWN_S = 120.0


def program_modules() -> types.SimpleNamespace:
    """The program's modules the benchmark drives (``src`` on the path)."""
    from repro_torch.common.types import DiffusionConfig
    from repro_torch.configs import get_unet_config
    from repro_torch.models import backend
    from repro_torch.serving import config, driver, engine, lanes

    return types.SimpleNamespace(
        DiffusionConfig=DiffusionConfig, get_unet_config=get_unet_config, backend=backend,
        config=config, driver=driver, engine=engine, lanes=lanes,
    )


@dataclasses.dataclass
class ReqLog:
    tier: str
    steps: int
    due: float | None = None
    submitted: float | None = None
    done: float | None = None
    queue_wait_s: float | None = None
    error: str | None = None


class Window:
    """Opens and closes the measured window between engine steps.

    The profiler of a traced run stops at the close, or, where
    ``trace_past_close`` (open loop), once the window's requests have
    finished: stopping takes seconds on the driver's thread, and requests
    still in flight would wait through it."""

    def __init__(self, engine, tracer=None, trace_past_close: bool = False):
        self.engine, self.tracer, self.trace_past_close = engine, tracer, trace_past_close
        self.want_open = self.want_close = self.want_trace_stop = False
        self.opened, self.closed = threading.Event(), threading.Event()
        self.traced = threading.Event()
        self.t_open = self.t_close = 0.0
        self.counters: dict[str, dict[str, int]] = {}
        self.mem_peak = 0

    def _snap(self) -> dict[str, int]:
        m = self.engine.metrics
        return {k: int(getattr(m, k)) for k in COUNTERS}

    @property
    def tracing(self) -> bool:
        return self.tracer is not None and self.opened.is_set() and not self.traced.is_set()

    def boundary(self) -> None:
        """Called on the driver's thread before each engine step."""
        if self.want_open and not self.opened.is_set():
            if self.tracer is not None:
                self.tracer.start()
            self.counters["open"] = self._snap()
            self.t_open = time.perf_counter()
            self.opened.set()
        elif self.want_close and self.opened.is_set() and not self.closed.is_set():
            self.t_close = time.perf_counter()
            self.counters["close"] = self._snap()
            self.closed.set()
        if self.tracing and self.closed.is_set() and (
                self.want_trace_stop or not self.trace_past_close):
            self.tracer.stop()
            self.traced.set()


def warm_requests(P, policy, cfg: dict, n: int, model) -> list:
    """``n`` short balanced requests whose plans run FULL, SKETCH and REFINE
    micro-steps with every lane busy, then decode: every shape the window
    uses, once."""
    u = cfg["unet"]
    L = u["latent_size"] ** 2
    pol = policy.resolve(6, quality="balanced")
    import numpy as np

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n):
        cond = model.conditioning(u, rng)
        reqs.append(P.engine.GenRequest(
            rid=-1 - i, **cond, noise=rng.normal(size=(L, u["in_channels"])).astype(np.float32),
            timesteps=6, plan=pol.plan, policy=pol))
    return reqs


def check_config(P, cfg: dict):
    """The program's U-Net config of this name, held to the file's numbers."""
    ucfg = P.get_unet_config(cfg["name"])
    for key, want in cfg["unet"].items():
        have = getattr(ucfg, key)
        if (list(have) if isinstance(have, tuple) else have) != want:
            raise ValueError(f"{cfg['name']}: program has {key}={have!r}, the file {want!r}")
    s = cfg["sampler"]
    dcfg = P.DiffusionConfig(
        timesteps_train=s["timesteps_train"], timesteps_sample=s["steps"],
        scheduler=s["scheduler"], beta_start=s["beta_start"], beta_end=s["beta_end"],
        beta_schedule=s["beta_schedule"], guidance_scale=s["guidance_scale"])
    return ucfg, dcfg


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             backend: str = "cuda", t_start: float | None = None) -> dict:
    """Serve ``cell`` for a window of ``seconds``; returns the run's record
    (see ``bench/metrics``) with the completed requests' outputs under
    ``outputs``."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    P = program_modules()
    cfg, mix, e, model = cell.config, cell.mix, cell.config["engine"], cell.model
    ucfg, dcfg = check_config(P, cfg)
    traffic = Traffic(mix, cfg, seed, model)
    tracer = None
    if trace:
        from bench import trace as T

        T.install(P)
        tracer = T.Tracer()
    class_flops = flops.class_flops(cfg["unet"], e["l_sketch"], e["l_refine"], model)
    unet_w, vae_w = make_weights(cfg["unet"], seed, device, model)
    config = P.engine.EngineConfig(
        n_lanes=e["n_lanes"], max_steps=cfg["sampler"]["steps"], l_sketch=e["l_sketch"],
        l_refine=e["l_refine"], decode_images=True, cache_mode=e["cache_mode"],
        backend=backend, device=device, unet=cfg["name"], seed=int(seed) % 2**63,
        window=e["window"], max_inflight=e["max_inflight"])
    bundle = P.config.build_engine(config, models=(ucfg, dcfg, unet_w, vae_w))
    engine, policy = bundle.engine, bundle.policy
    engine.run(warm_requests(P, policy, cfg, e["n_lanes"], model))
    t_warm = time.perf_counter()

    window = Window(engine, tracer, trace_past_close=traffic.open_loop)
    outputs: dict[int, tuple[Any, Any]] = {}
    step = engine.step

    def window_step(*args, **kwargs):
        window.boundary()
        if window.tracing:
            with tracer.step_range():
                done = step(*args, **kwargs)
        else:
            done = step(*args, **kwargs)
        for c in done:
            outputs[c.rid] = (c.latent, c.image)
        return done

    engine.step = window_step
    driver = P.driver.EngineDriver(engine, max_inflight=e["max_inflight"]).start()
    logs: dict[int, ReqLog] = {}
    step_events: list[tuple[float, int, int]] = []
    lock = threading.Lock()
    state = {"next": 0, "done": 0, "stop": False}
    arr = mix["arrivals"]
    open_after_done = mix["window"].get("after_done")
    cap = e["n_lanes"] + int(arr.get("queued", 0))

    def submit() -> None:
        with lock:
            i = state["next"]
            state["next"] += 1
        r = traffic.request(i)
        pol = policy.resolve(r.steps, quality=r.tier)
        log = ReqLog(r.tier, r.steps, due=traffic.due_s(i) + t_traffic if traffic.open_loop else None)
        logs[i] = log
        req = P.engine.GenRequest(rid=i, **r.cond, noise=r.noise, timesteps=r.steps,
                                  plan=pol.plan, policy=pol)
        log.submitted = time.perf_counter()
        try:
            driver.submit(req, on_event=lambda ev, i=i: on_event(i, ev))
        except P.driver.SubmitRejected as err:
            log.error = f"rejected: {err}"

    def on_event(i: int, ev: dict) -> None:
        now = time.perf_counter()
        kind, log = ev["event"], logs[i]
        if kind == "step":
            step_events.append((now, i, ev["step"]))
            if (not traffic.open_loop and i == 0 and ev["step"] % arr["stagger_steps"] == 0
                    and state["next"] < e["n_lanes"] and not state["stop"]):
                submit()
                if state["next"] == e["n_lanes"]:
                    for _ in range(cap - e["n_lanes"]):
                        submit()
        elif kind == "done":
            log.done, log.queue_wait_s = now, ev["queue_wait_s"]
            state["done"] += 1
            if open_after_done is not None and state["done"] >= open_after_done:
                window.want_open = True
            if not traffic.open_loop and not state["stop"] and state["next"] >= e["n_lanes"]:
                submit()
        elif kind == "cancelled" and state["stop"]:
            pass  # the benchmark's own cancellation once the run is over
        elif kind in ("error", "cancelled"):
            log.error = log.error or f"{kind}: {ev.get('error', '')}"

    def generate() -> None:
        i = 0
        while not state["stop"]:
            wait = traffic.due_s(i) + t_traffic - time.perf_counter()
            if wait > 0:
                time.sleep(min(wait, 0.05))
                continue
            submit()
            i += 1

    t_traffic = time.perf_counter()
    due_window = gen_thread = None
    if traffic.open_loop:
        # the window's requests are those the schedule makes due in it,
        # fixed by the schedule and not by where an engine step falls
        after = float(mix["window"]["after_s"])
        due_window = (t_traffic + after, t_traffic + after + seconds)
        gen_thread = threading.Thread(target=generate, name="bench-generator", daemon=True)
        gen_thread.start()
    else:
        submit()
    if "after_s" in mix["window"]:
        timer = threading.Timer(max(0.0, t_traffic + mix["window"]["after_s"] - time.perf_counter()),
                                lambda: setattr(window, "want_open", True))
        timer.daemon = True
        timer.start()
    try:
        if not window.opened.wait(timeout=FILL_LIMIT_S):
            raise RuntimeError("the window did not open: no engine step after the fill")
        time.sleep(max(0.0, window.t_open + seconds - time.perf_counter()))
        window.want_close = True
        if not window.closed.wait(timeout=120):
            raise RuntimeError("the window did not close: the engine stopped stepping")
        if device != "cpu":
            window.mem_peak = torch.cuda.max_memory_allocated()
        if traffic.open_loop:  # the window's requests finish under the same load
            deadline = window.t_close + float(mix["window"]["drain_s"])
            while time.perf_counter() < deadline and any(
                    log.done is None and log.error is None and due_window[0] <= log.due < due_window[1]
                    for log in list(logs.values())):
                time.sleep(0.05)
        if tracer is not None:
            window.want_trace_stop = True
            if not window.traced.wait(timeout=SHUTDOWN_S):
                raise RuntimeError("the profiler did not stop: the engine stopped stepping")
    finally:
        state["stop"] = True
        if gen_thread is not None:
            gen_thread.join(timeout=10)
        for i in list(logs):
            driver.cancel(i)
        driver.shutdown(timeout=SHUTDOWN_S)
    trace_summary = tracer.summary() if tracer is not None else None
    record = dict(
        cell=cell.name, seed=int(seed), seconds=seconds, device=device,
        setup_s=window.t_open - t_start, warm_s=t_warm - t_start,
        window=dict(open=window.t_open, close=window.t_close, s=window.t_close - window.t_open),
        traffic_start=t_traffic, due_window=due_window, n_lanes=e["n_lanes"],
        open_loop=traffic.open_loop,
        drain_s=float(mix["window"].get("drain_s", 0.0)),
        requests={i: dataclasses.asdict(log) for i, log in logs.items()},
        step_events=step_events, counters=window.counters, class_flops=class_flops,
        branches={t: model.pas_branches(model.tier_plan(t, traffic.steps), traffic.steps)
                  for t in set(log.tier for log in logs.values())},
        mem_peak=window.mem_peak, trace=trace_summary, outputs=outputs,
    )
    del driver, engine, bundle, unet_w, vae_w, window
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return record
