"""Dedicated driver thread for the continuous-batching engine.

Port of ``repro/serving/driver.py``.  The engine is a synchronous
single-owner object: ``submit`` / ``step`` / ``cancel`` mutate device state
and host mirrors with no internal locking, and every kernel launch of a
micro-step is queued from the calling thread.  :class:`EngineDriver`
gives an engine a single home thread — *every* engine call happens on the
driver thread, fed by a thread-safe submission queue — so any number of
frontend threads (the asyncio HTTP frontend, a benchmark harness, tests)
can submit, cancel and observe concurrently without touching the engine.

Life of a request::

    frontend thread                 driver thread
    ---------------                 -------------
    driver.submit(req, on_event)
      -> inbox message  ----------> engine.submit(req)      "queued"
                                    engine.step() x K       "step" per advance
                                    lane retires            "done"      (terminal)
    driver.cancel(rid)  ----------> engine.cancel(rid)      "cancelled" (terminal)

Backpressure is enforced at :meth:`submit`, which never blocks: when the
system already holds ``max_inflight`` open requests (queued + in-lane), it
raises :class:`SubmitRejected` — the HTTP frontend maps that to 429.  The
bound counts *requests*, not inbox messages, so control traffic (cancels,
stats probes) can never be refused; the inbox itself is a single FIFO,
which is what makes submit-then-cancel race-free (a cancel can never
overtake the submission it targets).

Events are plain dicts with an ``"event"`` key — ``queued``, ``step``,
then exactly one terminal ``done`` / ``cancelled`` / ``error`` per
accepted request.  Callbacks run on the driver thread and must not block
(the HTTP frontend just trampolines them onto the asyncio loop).

:meth:`shutdown` drains gracefully: new submissions are refused, every
request already accepted runs to completion (or cancellation), then the
thread exits and the final serving summary is returned.

While a profiler started on the driver thread collects, each iteration's
inbox pump and event delivery (callbacks included) run in the
``driver.inbox`` and ``driver.events`` ranges (:mod:`repro_torch.common.trace`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.common import trace as T
from repro_torch.serving.engine import CompletedRequest, GenRequest

#: event names that end a request's stream
TERMINAL_EVENTS = ("done", "cancelled", "error")
#: how long the idle driver thread waits on its inbox before it looks at
#: the engine again
IDLE_WAIT_S = 0.02


class SubmitRejected(RuntimeError):
    """The driver refused a submission (at capacity, draining, or stopped)."""


def latent_digest(latent: np.ndarray) -> str:
    """Stable short content hash of a finished latent's float32 bytes (what
    the HTTP frontend streams instead of the tensor itself)."""
    return hashlib.sha256(np.ascontiguousarray(latent).tobytes()).hexdigest()[:16]


def group_digest(digests: list[str]) -> str:
    """A variation group's combined digest: over its members' digests in
    variant order."""
    return hashlib.sha256("".join(digests).encode()).hexdigest()[:16]


@dataclasses.dataclass
class _Ticket:
    """Host bookkeeping for one accepted request."""

    req: GenRequest
    on_event: Callable[[dict], None] | None
    last_step: int = -1  # last step index already announced


@dataclasses.dataclass
class _Group:
    """Host bookkeeping for one variation fan-out (K member requests,
    one event stream keyed by the group id)."""

    gid: int
    on_event: Callable[[dict], None] | None
    members: list[int]  # member rids in variant order
    queued: int = 0
    terminal: int = 0
    cancelled: int = 0
    errors: list[str] = dataclasses.field(default_factory=list)
    digests: list[str | None] = dataclasses.field(default_factory=list)
    latency_s: float = 0.0
    queue_wait_s: float = 0.0
    steps: int = 0


class EngineDriver:
    """Single-threaded event loop around a ``DiffusionEngine``.

    The driver may also be used without :meth:`start` — submissions queue
    up in the inbox and are only consumed once the thread runs — which is
    how the tests make backpressure and drain deterministic.
    """

    def __init__(self, engine, max_inflight: int = 32):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.engine = engine
        self.max_inflight = max_inflight

        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._tickets: dict[int, _Ticket] = {}  # open rids (queued or in-lane)
        self._groups: dict[int, _Group] = {}  # open variation fan-outs by gid
        self._stopping = False
        self._thread: threading.Thread | None = None
        self._final_summary: dict | None = None
        #: called (from the driver thread) if the engine crashes, AFTER the
        #: open streams were failed — the HTTP frontend hooks its shutdown
        #: here so a dead engine can't leave a zombie server answering 503
        self.on_crash: Callable[[BaseException], None] | None = None

        self._t0 = time.perf_counter()
        self.n_accepted = 0
        self.n_completed = 0
        self.n_cancelled = 0
        self.n_rejected = 0

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    # -- frontend-side API (any thread) -------------------------------------

    @property
    def open_requests(self) -> int:
        return len(self._tickets)

    @property
    def draining(self) -> bool:
        return self._stopping

    def start(self) -> "EngineDriver":
        if self._thread is not None:
            raise RuntimeError("driver already started")
        self._thread = threading.Thread(
            target=self._run, name="engine-driver", daemon=True
        )
        self._thread.start()
        return self

    def submit(self, req: GenRequest, on_event: Callable[[dict], None] | None = None) -> int:
        """Hand one request to the driver; returns its rid.

        Never blocks: raises :class:`SubmitRejected` when draining/stopped
        or when ``max_inflight`` requests are already open.  Stamps the
        request's ``arrival_s`` with the driver clock so completion events
        carry real queue+service latencies.
        """
        with self._lock:
            if self._stopping:
                self.n_rejected += 1
                raise SubmitRejected("draining: not accepting new requests")
            if len(self._tickets) >= self.max_inflight:
                self.n_rejected += 1
                raise SubmitRejected(
                    f"at capacity: {self.max_inflight} requests already open"
                )
            if req.rid in self._tickets:
                raise SubmitRejected(f"rid {req.rid} is already open")
            req.arrival_s = self._clock()
            self._tickets[req.rid] = _Ticket(req, on_event)
            self.n_accepted += 1
            # enqueue under the lock: once the ticket is visible, a racing
            # cancel() must not get its message into the inbox first
            self._inbox.put(("submit", req.rid))
        return req.rid

    def submit_group(
        self,
        reqs: list[GenRequest],
        gid: int,
        on_event: Callable[[dict], None] | None = None,
    ) -> int:
        """Hand a variation fan-out to the driver as ONE logical request.

        The K member requests (same prompt context, distinct seeds) count
        individually against ``max_inflight`` — the whole group is accepted
        or rejected atomically — and their lanes are co-resident in the
        engine, which is what lets them share FULL-step cache captures by
        construction.  Events arrive on one stream keyed by ``gid``: one
        ``queued`` (with ``variants``), per-variant ``step`` events, one
        ``variant_done`` per member carrying its latent digest, then a
        single terminal ``done`` with all ``variant_digests``, a combined
        digest, and max member latency.  ``cancel(gid)`` aborts every
        still-open member.
        """
        if not reqs:
            raise ValueError("a variation group needs at least one member")
        with self._lock:
            if self._stopping:
                self.n_rejected += len(reqs)
                raise SubmitRejected("draining: not accepting new requests")
            if len(self._tickets) + len(reqs) > self.max_inflight:
                self.n_rejected += len(reqs)
                raise SubmitRejected(
                    f"at capacity: group of {len(reqs)} exceeds "
                    f"{self.max_inflight} open-request bound"
                )
            for req in reqs:
                if req.rid in self._tickets:
                    raise SubmitRejected(f"rid {req.rid} is already open")
            if gid in self._groups or gid in self._tickets:
                raise SubmitRejected(f"group id {gid} is already open")
            g = _Group(
                gid=gid, on_event=on_event,
                members=[r.rid for r in reqs],
                digests=[None] * len(reqs),
            )
            self._groups[gid] = g
            now = self._clock()
            for i, req in enumerate(reqs):
                req.arrival_s = now
                self._tickets[req.rid] = _Ticket(req, self._group_member_events(g, i))
                self.n_accepted += 1
                self._inbox.put(("submit", req.rid))
        return gid

    def _group_member_events(self, g: _Group, idx: int) -> Callable[[dict], None]:
        """Member-event translator: re-keys one member's stream onto the
        group id.  Runs on the driver thread only (like every callback), so
        the group counters need no extra locking."""

        def on_event(ev: dict) -> None:
            kind = ev.get("event")
            if kind == "queued":
                g.queued += 1
                if g.queued == len(g.members) and g.on_event is not None:
                    g.on_event({
                        "event": "queued", "rid": g.gid,
                        "variants": len(g.members),
                        "quality": ev.get("quality"),
                        "kernels": ev.get("kernels"),
                        "pending": ev.get("pending"), "active": ev.get("active"),
                    })
            elif kind == "step":
                if g.on_event is not None:
                    g.on_event({
                        "event": "step", "rid": g.gid, "variant": idx,
                        "step": ev["step"], "n_steps": ev["n_steps"],
                    })
            elif kind == "done":
                g.digests[idx] = ev["latent_digest"]
                g.latency_s = max(g.latency_s, ev["latency_s"])
                g.queue_wait_s = max(g.queue_wait_s, ev["queue_wait_s"])
                g.steps = max(g.steps, ev["steps"])
                g.terminal += 1
                if g.on_event is not None:
                    g.on_event({
                        "event": "variant_done", "rid": g.gid, "variant": idx,
                        "latent_digest": ev["latent_digest"],
                    })
                self._maybe_finish_group(g)
            elif kind == "cancelled":
                g.cancelled += 1
                g.terminal += 1
                self._maybe_finish_group(g)
            elif kind == "error":
                g.errors.append(str(ev.get("error", "engine error")))
                g.terminal += 1
                self._maybe_finish_group(g)

        return on_event

    def _maybe_finish_group(self, g: _Group) -> None:
        if g.terminal < len(g.members):
            return
        with self._lock:
            self._groups.pop(g.gid, None)
        if g.on_event is None:
            return
        if g.errors:
            g.on_event({"event": "error", "rid": g.gid, "error": g.errors[0]})
        elif g.cancelled:
            g.on_event({
                "event": "cancelled", "rid": g.gid,
                "variants_done": sum(d is not None for d in g.digests),
            })
        else:
            g.on_event({
                "event": "done",
                "rid": g.gid,
                "variants": len(g.members),
                "variant_digests": list(g.digests),
                "latent_digest": group_digest([d for d in g.digests if d is not None]),
                "latency_s": round(g.latency_s, 6),
                "queue_wait_s": round(g.queue_wait_s, 6),
                "steps": g.steps,
            })

    def cancel(self, rid: int) -> bool:
        """Ask the driver to abort a request (or a whole variation group by
        its gid); returns whether the id is currently open (the
        ``cancelled`` event is delivered async, on the request's own
        stream)."""
        with self._lock:
            g = self._groups.get(rid)
            if g is not None:
                members = [m for m in g.members if m in self._tickets]
                for m in members:
                    self._inbox.put(("cancel", m))
                return bool(members)
            known = rid in self._tickets
            if known:
                self._inbox.put(("cancel", rid))  # same lock as submit: FIFO holds
        return known

    def stats(self, timeout: float = 10.0) -> dict:
        """Serving-metrics snapshot, taken on the driver thread (so it is
        consistent with the event loop).  Falls back to the final summary
        once the thread has exited."""
        if self._thread is None or not self._thread.is_alive():
            return self._final_summary if self._final_summary is not None else self._snapshot()
        box: dict = {}
        ready = threading.Event()
        self._inbox.put(("stats", box, ready))
        deadline = time.perf_counter() + timeout
        while not ready.wait(0.1):
            if not self._thread.is_alive():
                # the loop exited (drain finished) before reading the probe
                return self._final_summary if self._final_summary is not None else self._snapshot()
            if time.perf_counter() >= deadline:
                raise TimeoutError("driver did not answer the stats probe")
        return box

    def cache_keys(self, since: int = 0, timeout: float = 10.0) -> dict:
        """Incremental cache key table (``GET /cache/keys`` payload), taken
        on the driver thread: only slots whose key generation exceeds
        ``since``, plus the current ``version`` cursor.  A cacheless engine
        answers an empty table (version 0) rather than erroring, so probes
        are safe against any engine config."""
        def _keys() -> dict:
            cache = getattr(self.engine, "cache", None)
            if cache is None or not hasattr(cache, "keys_delta"):
                return {"version": 0, "since": int(since), "rings": []}
            return cache.keys_delta(since)

        if self._thread is None or not self._thread.is_alive():
            return _keys()
        box: dict = {}
        ready = threading.Event()
        self._inbox.put(("keys", _keys, box, ready))
        deadline = time.perf_counter() + timeout
        while not ready.wait(0.1):
            if not self._thread.is_alive():
                return _keys()
            if time.perf_counter() >= deadline:
                raise TimeoutError("driver did not answer the cache-keys probe")
        return box

    def shutdown(self, timeout: float | None = None) -> dict:
        """Graceful drain: refuse new submissions, run everything already
        accepted to a terminal event, stop the thread, return the final
        summary.  Idempotent."""
        with self._lock:
            self._stopping = True
        self._inbox.put(("wake",))
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("driver did not drain in time")
        if self._final_summary is None:
            self._final_summary = self._snapshot()
        return self._final_summary

    # -- driver thread -------------------------------------------------------

    def _snapshot(self) -> dict:
        eng = self.engine
        eng.metrics.wall_s = self._clock()  # driver lifetime = serving wall
        cache = getattr(eng, "cache", None)
        cache_stats: dict = {}
        if cache is not None:
            # ring counters + warm-slot keys: what the replica router scores
            # incoming requests against (cross-process cache-warmth routing)
            cache_stats = dict(cache.stats())
            cache_stats["cache_slots_summary"] = cache.slots_summary()
        return dict(
            eng.metrics.summary(),
            **cache_stats,
            mode=eng._mode_name,
            lanes=eng.config.n_lanes,
            kernels=eng.config.kernels,
            accepted=self.n_accepted,
            completed=self.n_completed,
            cancelled=self.n_cancelled,
            rejected=self.n_rejected,
            open=len(self._tickets),
            active=eng.n_active,
            pending=eng.n_pending,
            drained=(not self._tickets and eng.n_active == 0 and eng.n_pending == 0),
        )

    def _emit(self, rid: int, event: dict) -> None:
        with self._lock:
            t = self._tickets.get(rid)
        if t is not None and t.on_event is not None:
            t.on_event(event)

    def _close_ticket(self, rid: int) -> _Ticket | None:
        with self._lock:
            return self._tickets.pop(rid, None)

    def _handle(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "submit":
            rid = msg[1]
            with self._lock:
                t = self._tickets.get(rid)
            if t is None:  # cancelled while still in the inbox
                return
            self.engine.submit(t.req)
            self._emit(rid, {
                "event": "queued", "rid": rid,
                "quality": t.req.quality_tier,
                "kernels": self.engine.config.kernels,
                "pending": self.engine.n_pending, "active": self.engine.n_active,
            })
        elif kind == "cancel":
            rid = msg[1]
            with self._lock:
                if rid not in self._tickets:
                    return  # already terminal
            at = {r: s for r, s, _ in self.engine.progress()}.get(rid)
            if not self.engine.cancel(rid):
                return  # retired in this same pump; "done" is on its way
            t = self._close_ticket(rid)
            self.n_cancelled += 1
            ev = {"event": "cancelled", "rid": rid,
                  "where": "queue" if at is None else "lane"}
            if at is not None:
                ev["at_step"] = at
            if t is not None and t.on_event is not None:
                t.on_event(ev)
        elif kind == "stats":
            _, box, ready = msg
            box.update(self._snapshot())
            ready.set()
        elif kind == "keys":
            _, keys_fn, box, ready = msg
            box.update(keys_fn())
            ready.set()
        # "wake" carries no payload — it only unblocks the idle get()

    def _pump_inbox(self, block: bool) -> None:
        if block:
            try:
                self._handle(self._inbox.get(timeout=IDLE_WAIT_S))
            except queue.Empty:
                return
        while True:
            try:
                self._handle(self._inbox.get_nowait())
            except queue.Empty:
                return

    def _announce_progress(self) -> None:
        for rid, step, n_steps in self.engine.progress():
            with self._lock:
                t = self._tickets.get(rid)
            if t is None or step <= t.last_step:
                continue
            t.last_step = step
            if t.on_event is not None:
                t.on_event({"event": "step", "rid": rid, "step": step, "n_steps": n_steps})

    def _finish(self, c: CompletedRequest) -> None:
        t = self._close_ticket(c.rid)
        self.n_completed += 1
        if t is not None and t.on_event is not None:
            if t.last_step < t.req.timesteps:
                # the advance that retired the lane isn't in progress()
                # any more — announce it so the stream really carries one
                # step event per advanced denoise step
                t.on_event({
                    "event": "step", "rid": c.rid,
                    "step": t.req.timesteps, "n_steps": t.req.timesteps,
                })
            t.on_event({
                "event": "done",
                "rid": c.rid,
                "latent_digest": latent_digest(c.latent),
                "latency_s": round(c.latency_s, 6),
                "queue_wait_s": round(c.queue_wait_s, 6),
                "steps": t.req.timesteps,
            })

    def _fail_open(self, err: BaseException) -> None:
        with self._lock:
            open_tickets = list(self._tickets.items())
            self._tickets.clear()
            self._stopping = True
        for rid, t in open_tickets:
            if t.on_event is not None:
                t.on_event({"event": "error", "rid": rid, "error": repr(err)})

    def _run(self) -> None:
        eng = self.engine
        try:
            while True:
                busy = eng.n_active > 0 or eng.n_pending > 0
                with T.phase("driver.inbox"):
                    self._pump_inbox(block=not busy)
                busy = eng.n_active > 0 or eng.n_pending > 0
                if not busy:
                    if self._stopping and self._inbox.empty():
                        break
                    continue
                done = eng.step(now_s=self._clock(), clock=self._clock)
                with T.phase("driver.events"):
                    self._announce_progress()
                    for c in done:
                        self._finish(c)
        except BaseException as err:  # engine failure: fail every open stream
            self._fail_open(err)
            self._final_summary = dict(self._snapshot(), error=repr(err))
            if self.on_crash is not None:
                try:
                    self.on_crash(err)
                except Exception:
                    pass  # the crash itself is what matters; re-raised below
            raise
        self._final_summary = self._snapshot()
