"""Async HTTP client + load generator for the serving frontend.

Port of ``repro/serving/client.py`` (stdlib and numpy only, like the
reference).

:class:`FrontendClient` speaks the frontend's minimal HTTP/1.1 dialect
(one request per connection, chunked NDJSON for streams) over raw asyncio
connections — stdlib only, like the server.  :func:`run_load` drives a
live server with either an open-loop Poisson arrival stream or a
closed-loop worker pool, mixes PAS and all-FULL plans, optionally cancels
requests mid-denoise, and reports goodput/latency/cancel statistics.

As a module it is the smoke driver of a live server::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --http 127.0.0.1:0 --port-file build/http.port &
  PYTHONPATH=src python -m repro_torch.serving.client --port-file build/http.port \
      --requests 5 --mode closed --concurrency 3 --mixed-plans --cancel 1 \
      --shutdown

exits non-zero unless every non-cancelled request completes (and every
requested cancellation lands), and ``--shutdown`` drains the server so the
launcher's exit code witnesses a clean drain.  With ``--router`` the
endpoint is a replica router (``repro_torch.launch.router``): the CLI also
requires its ``/stats`` sections and prints the per-replica summary.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time
from typing import AsyncIterator, Callable

import numpy as np

TERMINAL_EVENTS = ("done", "cancelled", "error")


class RequestRejected(RuntimeError):
    """Non-2xx response from the frontend (e.g. 429 backpressure)."""

    def __init__(self, status: int, payload: dict):
        super().__init__(f"HTTP {status}: {payload.get('error', payload)}")
        self.status = status
        self.payload = payload


async def _read_response_head(reader: asyncio.StreamReader) -> tuple[int, dict]:
    line = await reader.readline()
    parts = line.decode("latin-1").split()
    if len(parts) < 2:
        raise ConnectionError(f"malformed status line: {line!r}")
    status = int(parts[1])
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def _read_body(reader: asyncio.StreamReader, headers: dict) -> bytes:
    n = int(headers.get("content-length", 0))
    if n:
        return await reader.readexactly(n)
    return await reader.read()


async def _iter_chunked_lines(reader: asyncio.StreamReader) -> AsyncIterator[bytes]:
    """Yield NDJSON lines out of a chunked transfer-encoded body."""
    buf = b""
    while True:
        size_line = await reader.readline()
        size = int(size_line.strip() or b"0", 16)
        if size == 0:
            await reader.readline()  # trailing CRLF after the 0 chunk
            break
        data = await reader.readexactly(size)
        await reader.readexactly(2)  # chunk CRLF
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line
    if buf.strip():
        yield buf


class FrontendClient:
    """One frontend endpoint; a fresh connection per call (the server is
    ``Connection: close``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host, self.port = host, port

    async def _connect(self):
        return await asyncio.open_connection(self.host, self.port)

    def _head(self, method: str, path: str, body: bytes) -> bytes:
        return (
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: {self.host}:{self.port}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode() + body

    async def _request_json(self, method: str, path: str, payload: dict | None = None) -> dict:
        body = json.dumps(payload or {}).encode()
        reader, writer = await self._connect()
        try:
            writer.write(self._head(method, path, body))
            await writer.drain()
            status, headers = await _read_response_head(reader)
            out = json.loads((await _read_body(reader, headers)) or b"{}")
            if status >= 400:
                raise RequestRejected(status, out)
            return out
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- endpoints -----------------------------------------------------------

    async def health(self) -> dict:
        return await self._request_json("GET", "/healthz")

    async def stats(self) -> dict:
        return await self._request_json("GET", "/stats")

    async def cache_keys(self, since: int = 0) -> dict:
        """Incremental cache-key delta: every slot key whose generation
        counter is newer than ``since`` (the gossip protocol; see
        ``GET /cache/keys`` in docs/api.md)."""
        return await self._request_json("GET", f"/cache/keys?since={int(since)}")

    async def cancel(self, rid: int) -> dict:
        return await self._request_json("POST", "/cancel", {"rid": rid})

    async def shutdown(self) -> dict:
        return await self._request_json("POST", "/shutdown")

    async def generate_stream(
        self, on_event: Callable[[dict], None] | None = None, **payload
    ) -> AsyncIterator[dict]:
        """Submit one streamed generation; yields events as they arrive.

        Raises :class:`RequestRejected` on 4xx/5xx (429 = backpressure,
        503 = draining, 400 = bad payload).
        """
        payload.setdefault("stream", True)
        body = json.dumps(payload).encode()
        reader, writer = await self._connect()
        try:
            writer.write(self._head("POST", "/generate", body))
            await writer.drain()
            status, headers = await _read_response_head(reader)
            if status >= 400:
                body = await _read_body(reader, headers)
                raise RequestRejected(status, json.loads(body or b"{}"))
            async for line in _iter_chunked_lines(reader):
                ev = json.loads(line)
                if on_event is not None:
                    on_event(ev)
                yield ev
                if ev.get("event") in TERMINAL_EVENTS:
                    return
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def generate(self, **payload) -> dict:
        """Submit one generation and return its terminal event."""
        last = {}
        async for ev in self.generate_stream(**payload):
            last = ev
        return last

    async def wait_ready(self, timeout_s: float = 60.0) -> dict:
        """Poll /healthz until the server answers (the startup race)."""
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                return await self.health()
            except (ConnectionError, OSError):
                if time.perf_counter() >= deadline:
                    raise
                await asyncio.sleep(0.2)


# ---------------------------------------------------------------------------
# Load generation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoadStats:
    """Aggregate over one :func:`run_load` run."""

    submitted: int = 0
    completed: int = 0
    cancelled: int = 0
    rejected: int = 0
    failed: int = 0
    latencies_s: list[float] = dataclasses.field(default_factory=list)
    queue_waits_s: list[float] = dataclasses.field(default_factory=list)
    cancel_ack_s: list[float] = dataclasses.field(default_factory=list)
    cancelled_lane_steps: int = 0
    digests: dict[int, str] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_s) if self.latencies_s else np.zeros(1)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "rejected": self.rejected,
            "failed": self.failed,
            "wall_s": round(self.wall_s, 3),
            "goodput_req_s": round(self.completed / self.wall_s, 3) if self.wall_s else 0.0,
            "p50_latency_s": round(float(np.percentile(lat, 50)), 4),
            "p99_latency_s": round(float(np.percentile(lat, 99)), 4),
            "mean_queue_wait_s": round(float(np.mean(self.queue_waits_s)), 4)
            if self.queue_waits_s
            else 0.0,
            "cancel_ack_p50_s": round(float(np.percentile(self.cancel_ack_s, 50)), 4)
            if self.cancel_ack_s
            else 0.0,
            "cancelled_lane_steps": self.cancelled_lane_steps,
        }


#: the tier rotation `--quality mix` cycles through (the per-request knob)
QUALITY_TIERS = ("draft", "balanced", "high", "exact")

#: the task rotation `--task mix` cycles through (the v2 task union)
TASKS = ("txt2img", "img2img", "inpaint", "variations")


def make_payloads(
    n: int, t_lo: int, t_hi: int, plan_mode: str, seed: int,
    quality: str | None = None,
    task: str = "txt2img",
    v1: bool = False,
) -> list[dict]:
    """Synthetic payload stream: pooled prompts, mixed step counts.

    ``plan_mode``: ``mixed`` alternates PAS and all-FULL per request,
    ``pas`` / ``full`` are uniform.  ``quality`` adds the per-request
    quality knob: a fixed tier/number for every payload, or ``"mix"`` to
    rotate through the named tiers (the mixed-quality-stream workload);
    None omits the field (legacy plan_mode behaviour).

    The client speaks v2 natively: every payload carries ``task`` —
    a fixed task, or ``"mix"`` to rotate through the union — with the
    task's conditioning fields synthesized deterministically (img2img:
    seeded init + strength; inpaint: seeded init + half mask; variations:
    K=3).  ``v1=True`` keeps the flat pre-task payload for the compat-shim
    path (only valid with ``task="txt2img"``).
    """
    if v1 and task != "txt2img":
        raise ValueError(f"v1 flat payloads cannot express task {task!r}")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pas = {"mixed": i % 2 == 0, "pas": True, "full": False}[plan_mode]
        p = {
            "prompt": f"prompt-{int(rng.integers(4))}",
            "timesteps": int(rng.integers(t_lo, t_hi + 1)),
            "pas": pas,
            "seed": int(rng.integers(1 << 30)),
        }
        if quality == "mix":
            p["quality"] = QUALITY_TIERS[i % len(QUALITY_TIERS)]
        elif quality is not None:
            p["quality"] = quality
        t = TASKS[i % len(TASKS)] if task == "mix" else task
        if not v1:
            p["task"] = t
            if t in ("img2img", "inpaint"):
                p["init"] = {"seed": int(rng.integers(1 << 30))}
            if t == "img2img":
                p["strength"] = float(rng.choice((0.4, 0.75)))
            elif t == "inpaint":
                p["mask"] = {"kind": "half"}
            elif t == "variations":
                p["variants"] = 3
        out.append(p)
    return out


async def _drive_one(
    client: FrontendClient,
    payload: dict,
    stats: LoadStats,
    *,
    cancel_after_step: int | None = None,
    max_retries_429: int = 20,
) -> None:
    """Run one request to its terminal event, with 429 retry + optional
    mid-denoise cancellation after the request's Nth step event."""
    backoff = 0.05
    for _ in range(max_retries_429 + 1):
        cancel_issued_at: float | None = None
        terminal_seen = False
        try:
            async for ev in client.generate_stream(**payload):
                kind = ev.get("event")
                if kind in TERMINAL_EVENTS:
                    terminal_seen = True
                if (
                    kind == "step"
                    and cancel_after_step is not None
                    and ev["step"] >= cancel_after_step
                    and cancel_issued_at is None
                ):
                    cancel_issued_at = time.perf_counter()
                    await client.cancel(ev["rid"])
                elif kind == "done":
                    stats.completed += 1
                    stats.latencies_s.append(ev["latency_s"])
                    stats.queue_waits_s.append(ev["queue_wait_s"])
                    stats.digests[ev["rid"]] = ev["latent_digest"]
                elif kind == "cancelled":
                    stats.cancelled += 1
                    if cancel_issued_at is not None:
                        stats.cancel_ack_s.append(time.perf_counter() - cancel_issued_at)
                    stats.cancelled_lane_steps += int(ev.get("at_step", 0))
                elif kind == "error":
                    stats.failed += 1
            if not terminal_seen:  # stream died mid-flight (server gone?)
                stats.failed += 1
            return
        except RequestRejected as e:
            if e.status == 429:
                stats.rejected += 1
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
                continue
            stats.failed += 1
            return
        except (ConnectionError, OSError):
            stats.failed += 1
            return
    stats.failed += 1  # never got past backpressure


async def run_load(
    client: FrontendClient,
    *,
    requests: int,
    mode: str = "closed",
    concurrency: int = 4,
    rate_req_s: float = 4.0,
    t_lo: int = 3,
    t_hi: int = 6,
    plan_mode: str = "mixed",
    quality: str | None = None,
    task: str = "txt2img",
    v1: bool = False,
    cancel: int = 0,
    cancel_after_step: int = 1,
    seed: int = 0,
    payloads: list[dict] | None = None,
) -> LoadStats:
    """Drive a live frontend with ``requests`` generations.

    ``mode="closed"`` keeps ``concurrency`` requests in flight back-to-back
    (capacity measurement); ``mode="poisson"`` fires them open-loop at
    ``rate_req_s`` (latency-under-load measurement).  The first ``cancel``
    requests of the stream are cancelled mid-denoise, right after their
    ``cancel_after_step``-th step event.  ``payloads`` overrides the
    synthesized stream (the frontend benchmark passes the exact payloads
    its direct-engine phase served).
    """
    if payloads is None:
        payloads = make_payloads(
            requests, t_lo, t_hi, plan_mode, seed,
            quality=quality, task=task, v1=v1,
        )
    else:
        payloads = [dict(p) for p in payloads[:requests]]
    cancel_idx = set(range(min(cancel, requests)))
    for i in cancel_idx:
        # give cancel targets the longest plan so the mid-denoise cancel
        # always lands before the request could retire on its own
        payloads[i]["timesteps"] = t_hi
    stats = LoadStats(submitted=requests)
    t0 = time.perf_counter()

    if mode == "closed":
        pending: asyncio.Queue = asyncio.Queue()
        for i, p in enumerate(payloads):
            pending.put_nowait((i, p))

        async def worker():
            while True:
                try:
                    i, p = pending.get_nowait()
                except asyncio.QueueEmpty:
                    return
                await _drive_one(
                    client, p, stats,
                    cancel_after_step=cancel_after_step if i in cancel_idx else None,
                )

        await asyncio.gather(*(worker() for _ in range(max(1, concurrency))))
    elif mode == "poisson":
        rng = np.random.default_rng(seed + 1)
        gaps = rng.exponential(1.0 / rate_req_s, size=requests)
        tasks = []
        for i, p in enumerate(payloads):
            tasks.append(asyncio.create_task(_drive_one(
                client, p, stats,
                cancel_after_step=cancel_after_step if i in cancel_idx else None,
            )))
            await asyncio.sleep(float(gaps[i]))
        await asyncio.gather(*tasks)
    else:
        raise ValueError(f"mode must be closed|poisson, got {mode!r}")

    stats.wall_s = time.perf_counter() - t0
    return stats


# ---------------------------------------------------------------------------
# CLI (the smoke driver)
# ---------------------------------------------------------------------------


def _resolve_port(args) -> int:
    if args.port is not None:
        return args.port
    if not args.port_file:
        raise SystemExit("pass --port or --port-file")
    deadline = time.perf_counter() + args.port_timeout
    while True:
        try:
            with open(args.port_file) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            if time.perf_counter() >= deadline:
                raise SystemExit(
                    f"server port file {args.port_file!r} never appeared "
                    f"(waited {args.port_timeout:.0f}s)"
                )
            time.sleep(0.2)


async def _check_router(client: FrontendClient) -> bool:
    """The ``--router`` checks: the endpoint's ``/stats`` carries the
    router's sections, its fleet keeps the per-tier cache counters every
    replica publishes, and at least one replica is ready."""
    rstats = await client.stats()
    rblock = rstats.get("router")
    if not rblock:
        print(
            "[client] FAIL: --router but /stats carries no 'router' section "
            "(is the endpoint a plain server?)",
            file=sys.stderr,
        )
        return False
    print(f"[client] router: {rblock}")
    for rep in rstats.get("replicas", ()):
        line = {k: rep.get(k) for k in (
            "idx", "state", "generation", "respawns", "evictions", "inflight_routed",
        )}
        line["completed"] = (rep.get("stats") or {}).get("completed")
        print(f"[client] replica: {line}")
    ok = True
    fleet = rstats.get("fleet")
    if fleet:
        print(f"[client] fleet: {fleet}")
        # per-tier cache attribution must survive fleet aggregation: replicas
        # always publish these, so their absence means the router dropped them
        missing = [k for k in ("hbm_hits", "spill_promotions") if k not in fleet]
        if missing:
            print(
                f"[client] FAIL: fleet stats missing per-tier cache counters {missing}",
                file=sys.stderr,
            )
            ok = False
    if "gossip_routed" not in rblock:
        print("[client] FAIL: the router section has no gossip_routed counter",
              file=sys.stderr)
        ok = False
    return ok and rblock.get("ready", 0) >= 1


async def _amain(args) -> int:
    client = FrontendClient(args.host, _resolve_port(args))
    health = await client.wait_ready(args.port_timeout)
    print(f"[client] server ready: {health}")
    stats = await run_load(
        client,
        requests=args.requests,
        mode=args.mode,
        concurrency=args.concurrency,
        rate_req_s=args.rate,
        t_lo=args.t_lo,
        t_hi=args.t_hi,
        plan_mode=args.plan_mode,
        quality=args.quality,
        task=args.task,
        v1=args.v1,
        cancel=args.cancel,
        seed=args.seed,
    )
    summary = stats.summary()
    print(f"[client] {summary}")
    router_ok = await _check_router(client) if args.router else True
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
    # strict on cancellation counts: the cancel fires after the target's
    # first step event with the target on the longest plan, so it has the
    # rest of that plan to land in
    ok = (
        stats.completed == args.requests - args.cancel
        and stats.cancelled == args.cancel
        and stats.failed == 0
        and router_ok
    )
    if not ok:
        print(
            f"[client] FAIL: expected {args.requests - args.cancel} completed + "
            f"{args.cancel} cancelled, got {stats.completed} + {stats.cancelled} "
            f"({stats.failed} failed)",
            file=sys.stderr,
        )
    if args.shutdown:
        await client.shutdown()
        print("[client] shutdown requested (server draining)")
    return 0 if ok else 1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument(
        "--port-file", default=None,
        help="poll this file for the server's bound port (written by "
        "`repro_torch.launch.serve --http HOST:0 --port-file PATH`)",
    )
    ap.add_argument("--port-timeout", type=float, default=120.0)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--mode", choices=["closed", "poisson"], default="closed")
    ap.add_argument("--concurrency", type=int, default=4, help="closed-loop workers")
    ap.add_argument("--rate", type=float, default=4.0, help="poisson arrivals req/s")
    ap.add_argument("--t-lo", type=int, default=3)
    ap.add_argument("--t-hi", type=int, default=6)
    ap.add_argument(
        "--plan-mode", choices=["mixed", "pas", "full"], default="full",
        help="PAS/full plan mix of the stream",
    )
    ap.add_argument(
        "--mixed-plans", action="store_const", const="mixed", dest="plan_mode",
        help="shorthand for --plan-mode mixed",
    )
    ap.add_argument(
        "--quality", default=None, metavar="TIER|Q|mix",
        help="per-request quality knob in every payload: a named tier "
        "(draft|balanced|high|exact), a number in [0,1], or 'mix' to "
        "rotate through the tiers (mixed-quality stream)",
    )
    ap.add_argument(
        "--task", choices=[*TASKS, "mix"], default="txt2img",
        help="v2 task of every payload, or 'mix' to rotate through the union",
    )
    ap.add_argument(
        "--v1", action="store_true",
        help="send flat pre-task v1 payloads (compat-shim path; txt2img only)",
    )
    ap.add_argument(
        "--cancel", type=int, default=0,
        help="cancel this many requests mid-denoise (after their first step)",
    )
    ap.add_argument(
        "--router", action="store_true",
        help="the endpoint is a replica router (repro_torch.launch.router): assert "
        "the router /stats sections exist and print the per-replica summary",
    )
    ap.add_argument(
        "--shutdown", action="store_true",
        help="drain the server afterwards (POST /shutdown)",
    )
    ap.add_argument("--json", default=None, metavar="PATH", help="dump stats JSON")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    raise SystemExit(asyncio.run(_amain(args)))


if __name__ == "__main__":
    main()
