"""Replica gateway: spawn, supervise and route across N server replicas.

Port of ``repro/serving/router.py``.  One :class:`ReplicaRouter` process
fronts N independent server replicas, each a full
``repro_torch.launch.serve --http`` stack (engine + driver + frontend) in
its own subprocess on its own port, and turns them into a single
fault-tolerant endpoint:

* **Supervision**: every replica is health-checked over ``GET /healthz``;
  a crashed or unresponsive replica is evicted (killed, taken out of the
  routing set) and respawned under a deterministic exponential backoff
  (:class:`repro_torch.runtime.fault_tolerance.RestartBackoff`).  Probe
  round trips feed a
  :class:`~repro_torch.runtime.fault_tolerance.StragglerDetector` so a
  degraded replica is visible in ``/stats`` before it fails.
* **Routing**: ``POST /generate`` is proxied to the least-loaded ready
  replica, refined by a cache-warmth hint: replicas publish their
  :class:`~repro_torch.serving.cache.SlotRing` keys (timestep bucket,
  schedule offset, prompt signature) in ``GET /stats``, and the supervisor
  keeps a per-replica *gossip mirror* of them fresh through incremental
  ``GET /cache/keys?since=N`` deltas (new slot generations only, so the
  steady-state exchange is a few rows, not the ring).  The router scores
  each payload's synthesized signature against the mirror and counts
  admissions where warmth beat least-loaded placement as
  ``gossip_routed``.  Client-visible rids are router-allocated; replica
  rids are rewritten on every proxied event, so ``POST /cancel`` works on
  the router exactly as on a single server.
* **Failover**: requests the router has *accepted* (first ``queued`` event
  seen) are never lost to a replica crash: the stream emits an
  informational ``{"event": "requeued"}`` line and the payload is
  resubmitted to a healthy replica.  Every replica builds its weights from
  the same ``(unet, seed)``, so a failed-over request produces the *same*
  ``latent_digest`` it would have on the first replica (deterministic
  request synthesis + identical weights), as long as it runs alone there.
* **Rolling drain**: ``POST /shutdown`` (or SIGINT/SIGTERM via the
  launcher) drains replicas one at a time through their own ``/shutdown``
  path: in-flight requests finish, exit codes are collected, and the
  router's final summary reports ``drained`` only if every replica exited
  clean and no proxied stream was lost.

This module imports no torch: the gateway supervises engine *subprocesses*
but never builds an engine, so it imports only the stdlib HTTP plumbing
(:mod:`repro_torch.serving.http`), the async client
(:mod:`repro_torch.serving.client`) and numpy, and stays responsive while
replicas build, crash or respawn.  Run it via
``python -m repro_torch.launch.router``.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import subprocess
import time
from typing import Sequence

import numpy as np

from repro_torch.runtime.fault_tolerance import RestartBackoff, StragglerDetector
from repro_torch.serving.client import FrontendClient, RequestRejected
from repro_torch.serving.http import (
    DEPRECATION_HEADER,
    chunk,
    read_http_request,
    send_json,
    start_chunked,
)

#: event names that end a proxied stream (the driver's tuple, kept local so
#: the router never imports the torch-backed driver module)
TERMINAL_EVENTS = ("done", "cancelled", "error")

#: per-replica summary keys relayed in the router's aggregated ``/stats``
REPLICA_STAT_KEYS = (
    "requests", "completed", "open", "active", "pending",
    "mean_occupancy", "throughput_req_s", "micro_steps",
    "cache_hit_rate", "cache_warm_slots", "cache_probes",
    "cache_probe_hits", "cache_evictions", "kernels", "mode",
    "hbm_hits", "spill_promotions", "gossip_routed",
    "cache_spill_demotions", "cache_spill_promotions", "cache_spill_entries",
)

#: fleet counters summed across replicas in the router's ``/stats``
FLEET_SUM_KEYS = (
    "requests", "completed", "micro_steps", "full_steps", "sketch_steps",
    "refine_steps", "cache_probes", "cache_probe_hits", "cache_inserts",
    "cache_evictions", "hbm_hits", "spill_promotions", "gossip_routed",
    "cache_spill_demotions", "cache_spill_promotions", "cache_spill_entries",
)

#: supervision ticks between full ``/stats`` refreshes of a replica (key
#: deltas are pulled every tick)
STATS_EVERY = 4
#: pause before picking again when no replica is ready
RETRY_WAIT_S = 0.5
#: how long an accepted request waits for a ready replica to resume on
RESUME_TIMEOUT_S = 180.0
#: bound on the drain's wait for open proxied streams to flush
STREAM_FLUSH_TIMEOUT_S = 30.0


def _log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Routing policy: pure, host-cheap, unit-testable
# ---------------------------------------------------------------------------


def request_signature(payload: dict, ctx_len: int, ctx_dim: int) -> np.ndarray:
    """The payload's pooled prompt-embedding signature, synthesized exactly
    as the replica's :class:`~repro_torch.serving.frontend.RequestFactory`
    will synthesize it (same sha256 prompt mix, same rng stream, same
    pooling as :func:`repro_torch.serving.cache.prompt_signature`), so the
    router scores against *real* slot keys."""
    prompt = str(payload.get("prompt", ""))
    seed = int(payload.get("seed", 0))
    mix = int.from_bytes(hashlib.sha256(prompt.encode()).digest()[:8], "little")
    rng = np.random.default_rng((seed, mix))
    ctx = rng.normal(size=(ctx_len, ctx_dim)).astype(np.float32) * 0.2
    return ctx.mean(axis=0)


def signature_distance(sig: np.ndarray, ref: np.ndarray) -> float:
    """Shift-score-style relative distance: the expression of
    :func:`repro_torch.serving.cache.signature_distance`, kept here so the
    router does not import the torch-backed cache module."""
    ref = np.asarray(ref, np.float32)
    return float(
        np.linalg.norm(np.asarray(sig, np.float32) - ref) / (np.linalg.norm(ref) + 1e-12)
    )


def visited_buckets(payload: dict, routing: dict, t_bucket: int) -> tuple[int, list[int]]:
    """(schedule offset, timestep buckets) the payload's executed steps will
    visit: the host-side mirror of the replica's schedule-truncation math
    (img2img ``strength`` truncates to the *last* steps of the base
    schedule; the stride stays that of the untruncated one)."""
    base = int(payload.get("timesteps", routing["max_steps"]))
    base = max(1, base)
    executed = base
    if payload.get("task") == "img2img":
        strength = float(payload.get("strength", 0.75))
        executed = max(1, int(round(strength * base)))
    offset = base - executed
    stride = int(routing["timesteps_train"]) // base
    ts = (np.arange(base, dtype=np.int64) * stride)[::-1][offset:]
    return offset, sorted({int(t) // t_bucket for t in ts})


def payload_warmth(payload: dict, routing: dict, slots_summary: dict) -> float:
    """Fraction of the payload's visited timestep buckets that a replica's
    published warm slots would serve right now: same bucket, same schedule
    offset, signature distance strictly below the ring threshold.

    This is a routing *hint*, not the hit decision (the replica's own ring
    re-probes at the request's resolved per-step thresholds), so it uses
    the ring-default threshold and every visited bucket, not just FULL
    steps.  ``intra``-mode slots score 0: they are owner-rid-scoped and a
    freshly routed request can never consume them.
    """
    if not routing or not slots_summary:
        return 0.0
    if slots_summary.get("mode") != "cross":
        return 0.0
    threshold = float(slots_summary.get("threshold", 0.0))
    if threshold <= 0.0:
        return 0.0  # strict inequality: threshold 0 never hits
    slots = [s for ring in slots_summary.get("rings", ()) for s in ring]
    if not slots:
        return 0.0
    t_bucket = max(1, int(slots_summary.get("t_bucket", 125)))
    sig = request_signature(payload, int(routing["ctx_len"]), int(routing["ctx_dim"]))
    offset, buckets = visited_buckets(payload, routing, t_bucket)
    if not buckets:
        return 0.0
    warm = 0
    for b in buckets:
        for s in slots:
            if (
                int(s["bucket"]) == b
                and int(s.get("offset", 0)) == offset
                and signature_distance(sig, np.asarray(s["sig"], np.float32)) < threshold
            ):
                warm += 1
                break
    return warm / len(buckets)


def pick_replica(
    load_fracs: Sequence[float],
    warmths: Sequence[float] | None = None,
    warmth_weight: float = 1.0,
) -> int | None:
    """Least-loaded admission refined by cache warmth.

    Score = ``warmth_weight * warmth - load_frac``; ties resolve to the
    lower load, then the lower index, so with a cold fleet this is plain
    least-loaded, and warmth can pull a request onto a busier replica only
    when its slots are genuinely warm.
    """
    if not load_fracs:
        return None
    if warmths is None:
        warmths = [0.0] * len(load_fracs)
    best = 0
    best_score = warmth_weight * warmths[0] - load_fracs[0]
    for i in range(1, len(load_fracs)):
        score = warmth_weight * warmths[i] - load_fracs[i]
        if score > best_score + 1e-12 or (
            abs(score - best_score) <= 1e-12 and load_fracs[i] < load_fracs[best]
        ):
            best, best_score = i, score
    return best


# ---------------------------------------------------------------------------
# Replica supervision
# ---------------------------------------------------------------------------


class ReplicaHandle:
    """One supervised server-replica subprocess.

    Owns the process lifecycle (spawn → port-file wait → ready, kill,
    drain), the supervision counters (generation, respawns, evictions,
    consecutive probe failures) and the router-side load/warmth state
    (``inflight`` routed weight, last published ``/stats``).  States:
    ``down`` → ``starting`` → ``ready`` → (``draining`` →) ``down``.
    """

    #: loopback probes finish in microseconds; a straggler verdict below
    #: this floor would just be scheduler jitter, so RTTs are clamped up
    PROBE_RTT_FLOOR_S = 0.05

    def __init__(
        self,
        idx: int,
        cmd: Sequence[str],
        run_dir: str,
        *,
        host: str = "127.0.0.1",
        spawn_timeout_s: float = 300.0,
        backoff: RestartBackoff | None = None,
    ):
        self.idx = idx
        self.cmd = list(cmd)
        self.run_dir = run_dir
        self.host = host
        self.spawn_timeout_s = spawn_timeout_s
        self.backoff = backoff or RestartBackoff()
        self.probe_rtt = StragglerDetector()

        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.state = "down"
        self.generation = 0
        self.respawns = 0
        self.evictions = 0
        self.fails = 0  # consecutive failed health probes
        self.inflight = 0  # router-routed open weight (variants count K)
        self.max_inflight = 1
        self.last_stats: dict = {}
        # gossip mirror of the replica's warm slot keys: incremental
        # ``GET /cache/keys?since=N`` deltas merged by (ring, slot), so
        # steady-state refreshes move O(new slots) bytes, not the whole ring
        self.keys_version = 0
        self._key_mirror: dict[tuple[int, int], dict] = {}
        self._keys_meta: dict = {}
        self._probes = 0
        self._port_file: str | None = None
        self._log_file = None

    # -- state ---------------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def ready(self) -> bool:
        return self.state == "ready" and self.alive

    def client(self) -> FrontendClient:
        return FrontendClient(self.host, self.port)

    @property
    def load_frac(self) -> float:
        return self.inflight / max(self.max_inflight, 1)

    @property
    def log_path(self) -> str:
        """Every generation's output, appended to one file per replica."""
        return os.path.join(self.run_dir, f"replica{self.idx}.log")

    # -- lifecycle -----------------------------------------------------------

    def spawn(self) -> None:
        """Start (or restart) the replica process; a fresh generation gets a
        fresh port file, so a stale file from a killed generation can never
        be mistaken for the new port."""
        self.generation += 1
        if self.generation > 1:
            self.respawns += 1
        self.state = "starting"
        self.port = None
        self.fails = 0
        self.last_stats = {}
        self.keys_version = 0
        self._key_mirror = {}
        self._keys_meta = {}
        self._port_file = os.path.join(
            self.run_dir, f"replica{self.idx}.gen{self.generation}.port"
        )
        self._close_log()
        self._log_file = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            self.cmd + ["--port-file", self._port_file],
            stdout=self._log_file,
            stderr=subprocess.STDOUT,
        )

    def _close_log(self) -> None:
        if self._log_file is not None:
            with contextlib.suppress(OSError):
                self._log_file.close()
            self._log_file = None

    async def wait_ready(self, timeout_s: float | None = None) -> dict:
        """Poll the port file, then ``/healthz``, until the replica serves;
        returns the first health snapshot.  Raises if the process exits or
        the deadline passes first."""
        timeout_s = self.spawn_timeout_s if timeout_s is None else timeout_s
        deadline = time.perf_counter() + timeout_s
        while self.port is None:
            if not self.alive:
                raise RuntimeError(
                    f"replica {self.idx} exited during startup "
                    f"(code {self.proc.returncode if self.proc else None})"
                )
            try:
                with open(self._port_file) as f:
                    self.port = int(f.read().strip())
            except (FileNotFoundError, ValueError):
                if time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"replica {self.idx} never published its port "
                        f"(waited {timeout_s:.0f}s)"
                    ) from None
                await asyncio.sleep(0.2)
        health = await self.client().wait_ready(max(1.0, deadline - time.perf_counter()))
        self.max_inflight = int(health.get("max_inflight", self.max_inflight))
        self.state = "ready"
        self.backoff.reset()
        return health

    async def refresh_stats(self, timeout_s: float = 10.0) -> dict | None:
        """Fetch + store the replica's ``/stats`` (routing geometry and warm
        slot keys included); None (keeping the last snapshot) on failure."""
        if not self.ready:
            return None
        try:
            self.last_stats = await asyncio.wait_for(self.client().stats(), timeout_s)
            return self.last_stats
        except (RequestRejected, ConnectionError, OSError, asyncio.TimeoutError):
            return None

    async def refresh_keys(self, timeout_s: float = 10.0) -> dict | None:
        """Pull the replica's cache-key delta since the last seen generation
        and merge it into the gossip mirror; None (mirror untouched) on
        failure.

        A *backwards* version means the replica (or its cache) restarted
        under us: the mirror is discarded and rebuilt from a full since=0
        fetch, so stale keys from the dead generation can never score a
        warmth hint.
        """
        if not self.ready:
            return None
        try:
            delta = await asyncio.wait_for(
                self.client().cache_keys(self.keys_version), timeout_s
            )
            version = int(delta.get("version", 0))
            if version < self.keys_version:
                self._key_mirror.clear()
                self.keys_version = 0
                delta = await asyncio.wait_for(
                    self.client().cache_keys(0), timeout_s
                )
                version = int(delta.get("version", 0))
            for r, ring in enumerate(delta.get("rings", ())):
                for row in ring:
                    self._key_mirror[(r, int(row["slot"]))] = row
            self._keys_meta = {
                k: delta[k] for k in ("mode", "threshold", "t_bucket") if k in delta
            }
            self.keys_version = version
            return delta
        except (RequestRejected, ConnectionError, OSError, asyncio.TimeoutError,
                KeyError, TypeError, ValueError):
            return None

    def gossip_summary(self) -> dict:
        """The slots summary synthesized from gossiped key deltas: the shape
        of ``/stats``'s ``cache_slots_summary``, so the warmth scorer
        consumes either interchangeably.  Empty when nothing has gossiped
        yet (the caller falls back to the last ``/stats`` snapshot)."""
        if not self._key_mirror or not self._keys_meta:
            return {}
        return {
            **self._keys_meta,
            "version": self.keys_version,
            "rings": [list(self._key_mirror.values())],
        }

    def observe_probe(self, rtt_s: float) -> bool:
        """Feed one health-probe round trip to the straggler detector."""
        self._probes += 1
        return self.probe_rtt.observe(self._probes, max(rtt_s, self.PROBE_RTT_FLOOR_S))

    def kill(self) -> None:
        if self.alive:
            self.proc.kill()

    async def wait_exit(self, timeout_s: float = 60.0) -> int | None:
        """Wait for the process to exit; escalates to SIGKILL past the
        deadline.  Returns the exit code (None if there was no process)."""
        if self.proc is None:
            return None
        deadline = time.perf_counter() + timeout_s
        killed = False
        while self.proc.poll() is None:
            if not killed and time.perf_counter() >= deadline:
                self.kill()
                killed = True
            await asyncio.sleep(0.1)
        self._close_log()
        return self.proc.returncode

    async def drain(self, timeout_s: float = 300.0) -> int | None:
        """Graceful drain: ``POST /shutdown``, then wait for process exit."""
        self.state = "draining"
        if self.port is not None:
            with contextlib.suppress(
                RequestRejected, ConnectionError, OSError, asyncio.TimeoutError
            ):
                await asyncio.wait_for(self.client().shutdown(), 30.0)
        code = await self.wait_exit(timeout_s)
        self.state = "down"
        return code


@dataclasses.dataclass
class _Route:
    """Router-side bookkeeping for one proxied request."""

    rid: int  # router-allocated id, the one the client sees
    payload: dict
    weight: int = 1  # admission weight (a variation group counts K)
    replica: "ReplicaHandle | None" = None  # where it currently runs
    replica_rid: int | None = None  # its rid/gid on that replica
    attempts: int = 0  # replica streams tried
    accepted_once: bool = False  # a replica emitted "queued" at least once
    cancel_requested: bool = False


# ---------------------------------------------------------------------------
# The router server
# ---------------------------------------------------------------------------


class ReplicaRouter:
    """Asyncio HTTP gateway over a set of :class:`ReplicaHandle` s.

    Endpoints mirror the single-server frontend (``POST /generate``,
    ``POST /cancel``, ``GET /healthz``, ``GET /stats``, ``POST /shutdown``)
    with identical wire shapes, so every client (including
    ``repro_torch.serving.client``) points at a router unchanged.
    ``/stats`` additionally carries ``router`` / ``replicas`` / ``fleet``
    sections.
    """

    def __init__(
        self,
        replicas: Sequence[ReplicaHandle],
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        warmth_weight: float = 1.0,
        health_interval_s: float = 0.5,
        fail_threshold: int = 3,
        probe_timeout_s: float = 10.0,
        max_attempts: int = 8,
        drain_timeout_s: float = 300.0,
        respawn: bool = True,
    ):
        if not replicas:
            raise ValueError("the router needs at least one replica")
        self.replicas = list(replicas)
        self.host = host
        self.port = port
        self.warmth_weight = warmth_weight
        self.health_interval_s = health_interval_s
        self.fail_threshold = fail_threshold
        self.probe_timeout_s = probe_timeout_s
        self.max_attempts = max_attempts
        self.drain_timeout_s = drain_timeout_s
        self.respawn = respawn

        self._routes: dict[int, _Route] = {}
        self._rid = itertools.count()
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stopped: asyncio.Event | None = None
        self._streams_idle: asyncio.Event | None = None
        self._n_streams = 0
        self._draining = False
        self._shutdown_started = False
        self._supervisor_task: asyncio.Task | None = None
        self._respawn_tasks: dict[int, asyncio.Task] = {}
        # strong references to fire-and-forget tasks (the loop holds them weakly)
        self._tasks: set[asyncio.Task] = set()
        self.final_summary: dict | None = None

        self.n_accepted = 0
        self.n_completed = 0
        self.n_cancelled = 0
        self.n_failed = 0
        self.n_rejected = 0
        self.n_resubmitted = 0
        self.n_gossip_routed = 0  # admissions where warmth beat least-loaded

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "ReplicaRouter":
        """Spawn un-started replicas, wait for the whole fleet to serve,
        then bind the router socket and start the supervision loop."""
        self._loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        self._streams_idle = asyncio.Event()
        self._streams_idle.set()
        for h in self.replicas:
            if h.proc is None:
                h.spawn()
        try:
            await asyncio.gather(*(h.wait_ready() for h in self.replicas))
        except BaseException:
            self.kill_all()
            raise
        # prime routing geometry + slot summaries for the warmth hint
        await asyncio.gather(*(h.refresh_stats(self.probe_timeout_s) for h in self.replicas))
        await asyncio.gather(*(h.refresh_keys(self.probe_timeout_s) for h in self.replicas))
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._supervisor_task = asyncio.create_task(self._supervise())
        return self

    async def serve_until_shutdown(self) -> dict:
        """Serve until a rolling drain finishes; returns the final summary
        (``drained`` is True only for an all-clean exit)."""
        if self._server is None:
            raise RuntimeError("call start() first")
        async with self._server:
            await self._stopped.wait()
        return self.final_summary or {}

    def request_shutdown(self) -> None:
        """Signal-handler-safe entry into the rolling drain."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._spawn_task, self._drain_and_stop())

    def _spawn_task(self, coro) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def kill_all(self) -> None:
        """Hard-stop every replica process (startup failure / emergency)."""
        for h in self.replicas:
            h.kill()

    async def _drain_and_stop(self) -> None:
        if self._shutdown_started:
            return
        self._shutdown_started = True
        self._draining = True
        if self._supervisor_task is not None:
            self._supervisor_task.cancel()
        for t in list(self._respawn_tasks.values()):
            t.cancel()
        summaries: list[dict] = []
        for h in self.replicas:
            if h.proc is None or h.state == "down":
                # crash-evicted and not (yet) respawned: nothing to drain;
                # its requests already failed over, so this is a clean skip
                summaries.append({"idx": h.idx, "state": "down", "exit": None, "clean": True})
                continue
            if h.state == "starting":
                with contextlib.suppress(RuntimeError, TimeoutError, ConnectionError, OSError):
                    await h.wait_ready(60.0)
            _log(f"[router] draining replica {h.idx} (port {h.port})")
            code = await h.drain(self.drain_timeout_s)
            _log(f"[router] replica {h.idx} exited with code {code}")
            summaries.append({"idx": h.idx, "exit": code, "clean": code == 0})
        # proxied streams end as their replicas drain; let them flush their
        # terminal events to the client sockets (bounded, like the frontend)
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._streams_idle.wait(), STREAM_FLUSH_TIMEOUT_S)
        drained = all(s["clean"] for s in summaries) and not self._routes
        self.final_summary = {
            "drained": drained,
            "replicas": summaries,
            **self._router_counters(),
        }
        self._stopped.set()

    def _router_counters(self) -> dict:
        return {
            "accepted": self.n_accepted,
            "completed": self.n_completed,
            "cancelled": self.n_cancelled,
            "failed": self.n_failed,
            "rejected": self.n_rejected,
            "resubmitted": self.n_resubmitted,
            "gossip_routed": self.n_gossip_routed,
            "respawns": sum(h.respawns for h in self.replicas),
            "evictions": sum(h.evictions for h in self.replicas),
            "open": len(self._routes),
        }

    # -- supervision ---------------------------------------------------------

    async def _supervise(self) -> None:
        """Health-check loop: evict dead/unresponsive replicas, schedule
        respawns, refresh the stats snapshots the warmth hint scores on."""
        tick = 0
        try:
            while not self._draining:
                await asyncio.sleep(self.health_interval_s)
                tick += 1
                for h in list(self.replicas):
                    if self._draining:
                        return
                    if h.state != "ready":
                        continue
                    if not h.alive:
                        self._evict(h, f"process exited (code {h.proc.returncode})")
                        continue
                    t0 = time.perf_counter()
                    try:
                        health = await asyncio.wait_for(
                            h.client().health(), self.probe_timeout_s
                        )
                        h.fails = 0
                        h.max_inflight = int(health.get("max_inflight", h.max_inflight))
                        if h.observe_probe(time.perf_counter() - t0):
                            _log(
                                f"[router] replica {h.idx} health probe is straggling "
                                f"({time.perf_counter() - t0:.2f}s)"
                            )
                    except (ConnectionError, OSError, RequestRejected, asyncio.TimeoutError):
                        h.fails += 1
                        if h.fails >= self.fail_threshold:
                            self._evict(
                                h, f"{h.fails} consecutive health probes failed"
                            )
                    if tick % STATS_EVERY == 0:
                        await h.refresh_stats(self.probe_timeout_s)
                    # key deltas are cheap (new generations only), so gossip
                    # every tick: the warmth map trails admission by at most
                    # one health interval
                    await h.refresh_keys(self.probe_timeout_s)
        except asyncio.CancelledError:
            pass

    def _evict(self, h: ReplicaHandle, reason: str) -> None:
        """Take a replica out of the routing set (kill what is left of it)
        and schedule its respawn.  In-flight streams routed at it discover
        the death through their own broken connections and fail over."""
        h.evictions += 1
        _log(f"[router] evicting replica {h.idx}: {reason}")
        h.kill()
        h.state = "down"
        if self.respawn and not self._draining and h.idx not in self._respawn_tasks:
            task = asyncio.create_task(self._respawn(h))
            self._respawn_tasks[h.idx] = task
            task.add_done_callback(lambda _t: self._respawn_tasks.pop(h.idx, None))

    async def _respawn(self, h: ReplicaHandle) -> None:
        """Respawn loop for one evicted replica: backoff, spawn, wait ready;
        on failure, back off harder and try again (the backoff resets only
        once the replica is healthy)."""
        while not self._draining:
            delay = h.backoff.next_delay()
            _log(
                f"[router] respawning replica {h.idx} in {delay:.1f}s "
                f"(generation {h.generation + 1})"
            )
            try:
                await asyncio.sleep(delay)
            except asyncio.CancelledError:
                return
            if self._draining:
                return
            h.spawn()
            try:
                await h.wait_ready()
                await h.refresh_stats(self.probe_timeout_s)
                await h.refresh_keys(self.probe_timeout_s)
                _log(f"[router] replica {h.idx} ready again on port {h.port}")
                return
            except asyncio.CancelledError:
                return
            except (RuntimeError, TimeoutError, ConnectionError, OSError) as e:
                _log(f"[router] replica {h.idx} respawn failed: {e}")
                h.kill()
                h.state = "down"

    # -- routing -------------------------------------------------------------

    def _warmth(self, h: ReplicaHandle, payload: dict) -> float:
        stats = h.last_stats
        if not stats:
            return 0.0
        # the gossip mirror is fresher than the last full /stats snapshot
        # (incremental deltas merge on every supervision refresh); fall back
        # to the stats-published summary for replicas that never gossiped
        summary = h.gossip_summary() or stats.get("cache_slots_summary") or {}
        try:
            return payload_warmth(payload, stats.get("routing") or {}, summary)
        except Exception:
            # a hint only (any malformed field may raise): the payload gets
            # its structured 400 from the replica
            return 0.0

    def _pick(self, payload: dict, exclude: set[int] = frozenset()) -> ReplicaHandle | None:
        candidates = [h for h in self.replicas if h.ready and h.idx not in exclude]
        if not candidates:
            return None
        loads = [h.load_frac for h in candidates]
        warmths = [self._warmth(h, payload) for h in candidates]
        choice = pick_replica(loads, warmths, self.warmth_weight)
        if any(w > 0.0 for w in warmths) and choice != pick_replica(loads):
            # warmth overrode plain least-loaded placement: that is the
            # gossip map (or stats-published slot keys) steering admission
            self.n_gossip_routed += 1
        return candidates[choice]

    # -- connection handling ---------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, _headers, body = await read_http_request(reader)
            except (ValueError, asyncio.IncompleteReadError, ConnectionError):
                return
            try:
                payload = json.loads(body) if body else {}
            except json.JSONDecodeError:
                return await send_json(writer, 400, {"error": "body is not valid JSON"})

            if method == "GET" and path == "/healthz":
                await self._handle_health(writer)
            elif method == "GET" and path == "/stats":
                await self._handle_stats(writer)
            elif method == "POST" and path == "/generate":
                await self._handle_generate(writer, payload)
            elif method == "POST" and path == "/cancel":
                await self._handle_cancel(writer, payload)
            elif method == "POST" and path == "/shutdown":
                await send_json(writer, 202, {"draining": True})
                self._spawn_task(self._drain_and_stop())
            else:
                await send_json(writer, 404, {"error": f"no route {method} {path}"})
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_health(self, writer: asyncio.StreamWriter) -> None:
        ready = sum(1 for h in self.replicas if h.ready)
        status = "draining" if self._draining else ("ok" if ready else "degraded")
        await send_json(writer, 200, {
            "status": status,
            "mode": "router",
            "replicas": len(self.replicas),
            "ready": ready,
            "open": len(self._routes),
            "max_inflight": sum(h.max_inflight for h in self.replicas if h.ready),
            "pid": os.getpid(),
        })

    async def _handle_stats(self, writer: asyncio.StreamWriter) -> None:
        snapshots = await asyncio.gather(
            *(h.refresh_stats(self.probe_timeout_s) for h in self.replicas)
        )
        replicas = []
        for h, fresh in zip(self.replicas, snapshots):
            stats = fresh if fresh is not None else (h.last_stats or None)
            entry = {
                "idx": h.idx,
                "state": h.state,
                "port": h.port,
                "generation": h.generation,
                "respawns": h.respawns,
                "evictions": h.evictions,
                "inflight_routed": h.inflight,
                "max_inflight": h.max_inflight,
                "straggler_probes": len(h.probe_rtt.flagged),
            }
            if stats:
                entry["pid"] = (stats.get("routing") or {}).get("pid")
                entry["stats"] = {k: stats[k] for k in REPLICA_STAT_KEYS if k in stats}
            replicas.append(entry)
        fleet: dict = {}
        live = [s for s in (e.get("stats") for e in replicas) if s]
        for key in FLEET_SUM_KEYS:
            vals = [s[key] for s in live if isinstance(s.get(key), (int, float))]
            if vals:
                fleet[key] = sum(vals)
        occ = [s["mean_occupancy"] for s in live if isinstance(s.get("mean_occupancy"), (int, float))]
        if occ:
            fleet["mean_occupancy"] = round(sum(occ) / len(occ), 3)
        if fleet.get("cache_probes"):
            fleet["cache_hit_rate"] = round(
                fleet.get("cache_probe_hits", 0) / fleet["cache_probes"], 3
            )
        await send_json(writer, 200, {
            "router": {
                "replicas": len(self.replicas),
                "ready": sum(1 for h in self.replicas if h.ready),
                "warmth_weight": self.warmth_weight,
                **self._router_counters(),
            },
            "replicas": replicas,
            "fleet": fleet,
        })

    async def _handle_cancel(self, writer: asyncio.StreamWriter, payload: dict) -> None:
        try:
            rid = int(payload["rid"])
        except (KeyError, TypeError, ValueError):
            return await send_json(writer, 400, {"error": "body must carry an int rid"})
        route = self._routes.get(rid)
        if route is None:
            return await send_json(writer, 200, {"accepted": False, "rid": rid})
        route.cancel_requested = True
        if route.replica is not None and route.replica_rid is not None:
            # the terminal "cancelled" flows back on the proxied stream
            await self._try_cancel(route.replica, route.replica_rid)
        await send_json(writer, 200, {"accepted": True, "rid": rid})

    async def _try_cancel(self, h: ReplicaHandle, replica_rid: int | None) -> None:
        if replica_rid is None or h.port is None:
            return
        with contextlib.suppress(
            RequestRejected, ConnectionError, OSError, asyncio.TimeoutError
        ):
            await asyncio.wait_for(h.client().cancel(replica_rid), 10.0)

    # -- the proxied generate stream ------------------------------------------

    async def _handle_generate(self, writer: asyncio.StreamWriter, payload: dict) -> None:
        if not isinstance(payload, dict):
            return await send_json(writer, 400, {
                "error": {"code": "invalid", "field": "body",
                          "detail": "payload must be a JSON object"},
            })
        hdrs = (DEPRECATION_HEADER,) if "task" not in payload else ()
        if self._draining:
            self.n_rejected += 1
            return await send_json(
                writer, 503, {"error": "draining: not accepting new requests"}, hdrs
            )
        rid = next(self._rid)
        weight = 1
        if payload.get("task") == "variations":
            with contextlib.suppress(TypeError, ValueError):
                weight = max(1, int(payload.get("variants", 1)))
        route = _Route(rid=rid, payload=dict(payload), weight=weight)
        self._routes[rid] = route
        want_stream = bool(payload.get("stream", True))
        upstream = dict(payload, stream=True)  # the router always streams upstream
        started = False  # chunked response to the client begun
        rejected: set[int] = set()  # replicas that 429'd the current admission round
        no_replica_since: float | None = None
        self._n_streams += 1
        self._streams_idle.clear()
        try:
            while True:
                if route.cancel_requested:
                    # cancelled between replicas (pre-accept or mid-failover)
                    self.n_cancelled += 1
                    return await self._finish(
                        writer,
                        {"event": "cancelled", "rid": rid, "where": "router"},
                        hdrs, want_stream, started,
                    )
                if route.attempts >= self.max_attempts:
                    self.n_failed += 1
                    if started:
                        return await self._finish(writer, {
                            "event": "error", "rid": rid,
                            "error": f"gave up after {route.attempts} replica attempts",
                        }, hdrs, want_stream, started)
                    return await send_json(writer, 503, {
                        "error": f"no replica served the request after "
                                 f"{route.attempts} attempts",
                    }, hdrs)
                h = self._pick(route.payload, exclude=rejected)
                if h is None:
                    ready_idx = {r.idx for r in self.replicas if r.ready}
                    if ready_idx and ready_idx <= rejected and not route.accepted_once:
                        # every ready replica is at capacity: relay the
                        # backpressure; the client's 429 retry loop owns it
                        self.n_rejected += 1
                        return await send_json(
                            writer, 429, {"error": "all replicas at capacity"}, hdrs
                        )
                    # no ready replica right now (crash window, respawn in
                    # flight): wait for the supervisor, bounded in time
                    if no_replica_since is None:
                        no_replica_since = time.perf_counter()
                    elif time.perf_counter() - no_replica_since > RESUME_TIMEOUT_S:
                        self.n_failed += 1
                        if started:
                            return await self._finish(writer, {
                                "event": "error", "rid": rid,
                                "error": "no ready replica to resume on",
                            }, hdrs, want_stream, started)
                        return await send_json(
                            writer, 503, {"error": "no ready replicas"}, hdrs
                        )
                    rejected.clear()
                    await asyncio.sleep(RETRY_WAIT_S)
                    continue
                no_replica_since = None
                route.attempts += 1
                outcome, started = await self._proxy_attempt(
                    route, h, upstream, writer, hdrs, want_stream, started, rejected
                )
                if outcome == "terminal":
                    return
                # "retry": pick again (a 429 extended ``rejected``;
                # a broken stream fell through for failover)
        finally:
            self._routes.pop(rid, None)
            self._n_streams -= 1
            if self._n_streams == 0:
                self._streams_idle.set()

    async def _proxy_attempt(
        self,
        route: _Route,
        h: ReplicaHandle,
        upstream: dict,
        writer: asyncio.StreamWriter,
        hdrs: tuple,
        want_stream: bool,
        started: bool,
        rejected: set[int],
    ) -> tuple[str, bool]:
        """Stream one replica attempt to the client.

        Returns ``("terminal", started)`` when the client got its response
        (success, relayed rejection, or the client went away) and
        ``("retry", started)`` when the caller should pick another replica
        (429, recorded in ``rejected``, or a broken upstream stream).
        """
        rid = route.rid
        gen = h.client().generate_stream(**upstream)
        accepted_here = False
        try:
            try:
                ev = await gen.__anext__()
            except StopAsyncIteration:
                return "retry", started
            except RequestRejected as e:
                if e.status == 400:
                    # deterministic payload rejection: relay verbatim (the
                    # replica's structured error body, the replica's call)
                    self.n_rejected += 1
                    await send_json(writer, 400, e.payload, hdrs)
                    return "terminal", started
                if e.status == 429:
                    rejected.add(h.idx)
                # 503 = the replica started draining under us: not ready
                return "retry", started
            except (ConnectionError, OSError, asyncio.IncompleteReadError, ValueError):
                h.fails += 1
                return "retry", started

            # first event arrived: the replica accepted the request
            route.replica = h
            route.replica_rid = int(ev.get("rid", -1))
            h.inflight += route.weight
            accepted_here = True
            if not route.accepted_once:
                route.accepted_once = True
                self.n_accepted += 1
            if route.cancel_requested:
                # a cancel raced the submission: forward it now; the
                # cancelled terminal arrives on this same stream
                await self._try_cancel(h, route.replica_rid)

            while True:
                out = dict(ev, rid=rid)
                if ev.get("event") == "queued":
                    out["replica"] = h.idx
                    if route.attempts > 1:
                        out["attempt"] = route.attempts
                if want_stream:
                    if not started:
                        await start_chunked(writer, extra_headers=hdrs)
                        started = True
                    try:
                        writer.write(chunk((json.dumps(out) + "\n").encode()))
                        await writer.drain()
                    except (ConnectionError, OSError):
                        # the client went away mid-denoise: stop the replica
                        # burning lane-steps, count it cancelled
                        h.inflight -= route.weight
                        route.replica = None
                        self.n_cancelled += 1
                        await self._try_cancel(h, route.replica_rid)
                        return "terminal", started
                kind = ev.get("event")
                if kind in TERMINAL_EVENTS:
                    h.inflight -= route.weight
                    route.replica = None
                    if kind == "done":
                        self.n_completed += 1
                    elif kind == "cancelled":
                        self.n_cancelled += 1
                    else:
                        self.n_failed += 1
                    if want_stream:
                        writer.write(b"0\r\n\r\n")
                        await writer.drain()
                    else:
                        await send_json(writer, 200, out, hdrs)
                    return "terminal", started
                try:
                    ev = await gen.__anext__()
                except StopAsyncIteration:
                    raise ConnectionError(
                        "replica stream ended without a terminal event"
                    ) from None
        except (ConnectionError, OSError, asyncio.IncompleteReadError, ValueError) as err:
            # the replica (or its stream) died mid-request.  Whatever it
            # accepted is NOT lost: emit an informational requeue marker and
            # let the caller resubmit; deterministic synthesis + shared
            # weight seed make the retried digest identical.
            if accepted_here:
                h.inflight -= route.weight
                old_rid = route.replica_rid
                route.replica = None
                route.replica_rid = None
                self.n_resubmitted += 1
                _log(
                    f"[router] replica {h.idx} dropped rid {rid} mid-stream "
                    f"({err!r}); resubmitting"
                )
                # if the replica is actually still alive (transient socket
                # failure), stop the orphaned request server-side
                self._spawn_task(self._try_cancel(h, old_rid))
                if want_stream and started:
                    try:
                        marker = {"event": "requeued", "rid": rid,
                                  "replica": h.idx, "attempt": route.attempts}
                        writer.write(chunk((json.dumps(marker) + "\n").encode()))
                        await writer.drain()
                    except (ConnectionError, OSError):
                        self.n_cancelled += 1
                        return "terminal", started
            else:
                h.fails += 1
            return "retry", started
        finally:
            with contextlib.suppress(Exception):
                await gen.aclose()

    async def _finish(
        self, writer: asyncio.StreamWriter, ev: dict, hdrs: tuple,
        want_stream: bool, started: bool,
    ) -> None:
        """Deliver a router-synthesized terminal event in whichever framing
        the client asked for."""
        with contextlib.suppress(ConnectionError, OSError):
            if not want_stream:
                return await send_json(writer, 200, ev, hdrs)
            if not started:
                await start_chunked(writer, extra_headers=hdrs)
            writer.write(chunk((json.dumps(ev) + "\n").encode()))
            writer.write(b"0\r\n\r\n")
            await writer.drain()
