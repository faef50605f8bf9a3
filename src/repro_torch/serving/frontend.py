"""Asyncio HTTP frontend over the engine driver (stdlib only).

Port of ``repro/serving/frontend.py``, with the same endpoints, payloads,
events and error bodies; the kernel backend a payload may assert is the
port's (``"eager"`` | ``"cuda"``).

A thin async layer that turns the single-threaded serving engine into a
server real traffic can hit: requests arrive over HTTP, are materialized
into :class:`~repro_torch.serving.engine.GenRequest` s, and flow through the
:class:`~repro_torch.serving.driver.EngineDriver`'s thread-safe submission
queue.  Per-step progress streams back as chunked NDJSON, cancellation is
a separate endpoint (or just dropping the streaming connection), and
backpressure surfaces as HTTP 429.

Endpoints (HTTP/1.1, ``Connection: close``):

``POST /generate``
    v2 JSON body: ``{"task": "txt2img"|"img2img"|"inpaint"|"variations",
    "prompt": str, "timesteps": int, "quality": str|float, "plan": {...},
    "pas": bool, "seed": int, "allow_cache": bool, "stream": bool,
    "kernels": "eager"|"cuda"}`` plus
    the task's own fields — ``img2img``: ``init`` + ``strength``;
    ``inpaint``: ``init`` + ``mask``; ``variations``: ``variants`` (see
    ``repro_torch.serving.schema`` / ``docs/api.md``).  A payload *without* a
    ``task`` key is a v1 flat payload, accepted through the compat shim
    with a ``Deprecation`` response header.  Malformed payloads get
    structured 400s: ``{"error": {"code", "field", "detail"}}``.
    ``quality`` is the per-request quality knob — a named tier
    (``draft``/``balanced``/``high``/``exact``) or a number in [0, 1] —
    resolved by :mod:`repro_torch.serving.policy` into a PAS plan plus the
    request's cache thresholds (``exact`` = all-FULL + threshold 0 =
    bit-exact with today's default path); ``plan`` optionally overrides
    the tier's plan shape with explicit ``{t_sketch, t_complete, t_sparse,
    l_sketch, l_refine}`` fields (cache-geometry fields default to the
    engine's); ``pas`` is the legacy stock-plan switch, consulted only
    when no ``quality`` is given.  With ``stream`` (the default) the
    response is ``200`` chunked NDJSON — one JSON object per line:
    ``{"event": "queued", ...}``, one ``{"event": "step", "step": k,
    "n_steps": n}`` per advanced denoise step, then exactly one terminal
    ``done`` (with ``latent_digest``, ``latency_s``, ``queue_wait_s``) /
    ``cancelled`` / ``error``.  ``stream=false`` waits and returns just
    the terminal object.  ``429`` when the driver is at capacity, ``503``
    while draining, ``400`` on a malformed payload.
``POST /cancel``
    ``{"rid": int}`` → ``{"accepted": bool}``.  The ``cancelled`` event
    is delivered on the request's own stream.
``GET /healthz``
    Liveness + occupancy snapshot (lock-free, approximate).
``GET /stats``
    Full serving-metrics summary, taken on the driver thread — including
    per-branch-class executed-step counts (``full_steps`` /
    ``sketch_steps`` / ``refine_steps``), cache demotions + hit rate, and
    the per-quality-tier request mix (``quality_mix``), the active kernel
    backend (``kernels``), the host wall of ``engine.step`` per backend,
    device waits included (``step_time_by_backend``), and the part of it
    spent blocked on the device (``step_wait_s``): near the wall, the
    engine is device-bound; far below it, host-bound.  Mixed-quality
    streams are observable without the bench harness.
``GET /cache/keys?since=N``
    Incremental cache-key gossip: warm-slot key rows (bucket, signature,
    schedule offset, generation stamp — never features) written after
    generation ``N``, plus the current ``version`` cursor.  The replica
    router polls this instead of full ``/stats`` snapshots to keep its
    warmth map fresh cheaply; ``since=0`` (the default) returns the whole
    warm table.
``POST /shutdown``
    Graceful drain: ``202`` immediately, then stop accepting, run every
    in-flight request to a terminal event, flush the open streams, and
    stop the server loop.

Dropping a streaming connection mid-denoise cancels the request — a dead
client must not keep burning lane-steps.
"""
from __future__ import annotations

import asyncio
import hashlib
import itertools
import json
import os
import threading
from typing import Any

import numpy as np

from repro_torch.common.types import PASPlan
from repro_torch.models import unet as U
from repro_torch.serving.driver import TERMINAL_EVENTS, EngineDriver, SubmitRejected
from repro_torch.serving.engine import GenRequest
from repro_torch.serving.http import (
    DEPRECATION_HEADER,
    chunk,
    read_http_request,
    send_json,
    start_chunked,
)
from repro_torch.serving.policy import QualityPolicy
from repro_torch.serving.schema import PLAN_FIELDS, RequestSpec, SchemaError, parse_request

#: drain grace for open streams to flush their terminal events; a client
#: that stopped reading must not wedge shutdown forever
STREAM_FLUSH_TIMEOUT_S = 30.0


class RequestFactory:
    """Materializes HTTP payloads into :class:`GenRequest` s.

    The prompt string is hashed into the rng stream that synthesizes the
    prompt embedding, so equal ``(prompt, seed)`` payloads produce
    bit-equal requests — which is what makes the streamed
    ``latent_digest`` a deterministic function of the payload (cache off),
    and what gives the cross-request feature cache real prompt locality
    under repeated prompts.

    Quality knobs in the payload (``quality`` tier/number, explicit
    ``plan`` overrides, the legacy ``pas`` switch) resolve through one
    :class:`~repro_torch.serving.policy.QualityPolicy`; ``default_quality``
    applies to payloads that carry no knob of their own (the
    ``--quality`` CLI default).
    """

    def __init__(self, ucfg, dcfg, engine_config, policy=None, default_quality=None):
        self.ucfg, self.dcfg = ucfg, dcfg
        self.max_steps = engine_config.max_steps
        self.l_sketch = engine_config.l_sketch
        self.l_refine = engine_config.l_refine
        #: the engine's resolved kernel backend; payloads may only *assert* it
        self.backend = engine_config.kernels
        self.n_up = U.n_up_steps(ucfg)
        self.policy = (
            policy
            if policy is not None
            else QualityPolicy.for_engine(ucfg, dcfg, engine_config)
        )
        self.default_quality = default_quality
        self._rid = itertools.count()
        self._lock = threading.Lock()

    def _plan_from_spec(self, spec: dict | None, timesteps: int) -> PASPlan | None:
        if spec is None:
            return None
        unknown = set(spec) - set(PLAN_FIELDS)
        if unknown:
            raise SchemaError("unknown", "plan", f"unknown plan fields: {sorted(unknown)}")
        try:
            plan = PASPlan(
                t_sketch=int(spec["t_sketch"]),
                t_complete=int(spec["t_complete"]),
                t_sparse=int(spec["t_sparse"]),
                l_sketch=int(spec.get("l_sketch", self.l_sketch)),
                l_refine=int(spec.get("l_refine", self.l_refine)),
            )
        except KeyError as e:
            raise SchemaError(
                "missing", "plan", f"plan is missing field {e.args[0]!r}"
            ) from None
        try:
            plan.validate(timesteps, self.n_up)
        except ValueError as e:
            raise SchemaError("invalid", "plan", str(e)) from None
        return plan

    def _materialize_mask(self, mask_spec: dict, L: int) -> np.ndarray:
        """Mask spec -> concrete [L] float32 mask (1 = generate)."""
        kind = mask_spec["kind"]
        if kind == "ones":
            return np.ones((L,), np.float32)
        if kind == "half":
            m = np.ones((L,), np.float32)
            m[: int(round(float(mask_spec.get("frac", 0.5)) * L))] = 0.0
            return m
        values = np.asarray(mask_spec["values"], np.float32)
        if values.shape != (L,):
            raise SchemaError(
                "invalid", "mask",
                f"explicit mask needs {L} values, got {values.shape[0]}",
            )
        return values

    def _init_latent(self, init_seed: int, L: int) -> np.ndarray:
        """Deterministic synthetic init image for a ``{"seed": ...}`` handle.

        Drawn from its own rng stream (keyed off the handle seed, not the
        request seed) so txt2img request synthesis — and therefore every
        pre-v2 latent digest — is untouched by the new draw.
        """
        rng = np.random.default_rng((2, init_seed))
        return rng.normal(size=(L, self.ucfg.in_channels)).astype(np.float32)

    def build(self, payload: dict[str, Any]):
        """Validate one payload and materialize its engine request(s).

        Returns ``(requests, gid, spec)``: a single-element list and
        ``gid=None`` for txt2img/img2img/inpaint, or the K-member variant
        list plus the group id the driver should stream them under.
        Raises :class:`SchemaError` (a ``ValueError``) on any invalid
        payload.
        """
        spec = parse_request(payload, max_steps=self.max_steps)
        # the kernel backend is fixed at engine construction; the field is
        # accepted only as an assertion of what this server is running
        if spec.kernels is not None and spec.kernels != self.backend:
            raise SchemaError(
                "forbidden", "kernels",
                f"engine is serving kernels={self.backend!r}; per-request "
                "backend switching is not supported",
            )
        L = self.ucfg.latent_size**2
        # the policy resolves over the request's ACTUAL schedule: for a
        # strength-truncated img2img that is the tail of the base schedule,
        # so per-bucket thresholds land in the buckets its steps really
        # visit (and plan shapes size to the executed length)
        if spec.timesteps < spec.base_timesteps:
            stride = self.dcfg.timesteps_train // spec.base_timesteps
            ts_vec = (np.arange(spec.base_timesteps, dtype=np.int64) * stride)[::-1]
            resolve_steps: int | np.ndarray = ts_vec[
                spec.base_timesteps - spec.timesteps:
            ]
        else:
            resolve_steps = spec.timesteps
        quality = spec.quality if spec.quality is not None else self.default_quality
        pol = self.policy.resolve(
            resolve_steps,
            quality=quality,
            pas=spec.pas,
            plan=self._plan_from_spec(spec.plan_spec, spec.timesteps),
        )
        mix = int.from_bytes(hashlib.sha256(spec.prompt.encode()).digest()[:8], "little")
        rng = np.random.default_rng((spec.seed, mix))
        ctx = rng.normal(size=(self.ucfg.ctx_len, self.ucfg.ctx_dim)).astype(np.float32) * 0.2
        noise = rng.normal(size=(L, self.ucfg.in_channels)).astype(np.float32)

        if spec.task == "variations":
            # variant 0 reuses the txt2img noise; later variants draw
            # sequentially from the same stream, so the fan-out is a
            # deterministic function of (prompt, seed, K)
            noises = [noise] + [
                rng.normal(size=(L, self.ucfg.in_channels)).astype(np.float32)
                for _ in range(spec.variants - 1)
            ]
            with self._lock:
                rids = [next(self._rid) for _ in range(spec.variants)]
                gid = next(self._rid)
            reqs = [
                GenRequest(
                    rid=rid,
                    ctx=ctx,
                    noise=nz,
                    timesteps=spec.timesteps,
                    plan=pol.plan,
                    allow_cache=spec.allow_cache,
                    policy=pol,
                )
                for rid, nz in zip(rids, noises)
            ]
            return reqs, gid, spec

        init_latent = (
            self._init_latent(spec.init_seed, L) if spec.init_seed is not None else None
        )
        mask = (
            self._materialize_mask(spec.mask_spec, L)
            if spec.mask_spec is not None
            else None
        )
        with self._lock:
            rid = next(self._rid)
        req = GenRequest(
            rid=rid,
            ctx=ctx,
            noise=noise,
            timesteps=spec.timesteps,
            plan=pol.plan,
            allow_cache=spec.allow_cache,
            policy=pol,
            init_latent=init_latent,
            mask=mask,
            base_timesteps=spec.base_timesteps,
        )
        return [req], None, spec


# ---------------------------------------------------------------------------
# The frontend server
# ---------------------------------------------------------------------------


class HTTPFrontend:
    """Asyncio HTTP server bridging client connections to the driver.

    Driver events are emitted on the driver thread; each ``/generate``
    handler installs a trampoline that ``call_soon_threadsafe``-forwards
    them into a per-request ``asyncio.Queue``, so the event loop never
    blocks on the engine and the engine never blocks on a slow client.
    """

    def __init__(
        self,
        driver: EngineDriver,
        factory: RequestFactory,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.driver = driver
        self.factory = factory
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None
        self._stopped: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._n_streams = 0
        self._streams_idle: asyncio.Event | None = None
        self._shutdown_started = False
        self.final_summary: dict | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "HTTPFrontend":
        self._loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        self._streams_idle = asyncio.Event()
        self._streams_idle.set()
        # an engine crash must take the server down (summary carries the
        # error and drained=False), not leave a zombie answering 503
        self.driver.on_crash = lambda err: self.request_shutdown()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_until_shutdown(self) -> dict:
        """Serve until a drain finishes (``POST /shutdown`` or
        :meth:`request_shutdown`); returns the driver's final summary."""
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._stopped.wait()
        return self.final_summary or {}

    def request_shutdown(self) -> None:
        """Signal-handler-safe entry into the graceful drain."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: self._loop.create_task(self._drain_and_stop())
            )

    async def _drain_and_stop(self) -> None:
        if self._shutdown_started:
            return
        self._shutdown_started = True
        loop = asyncio.get_running_loop()
        # drain on the default executor: shutdown() blocks on the driver
        # thread finishing every in-flight request
        self.final_summary = await loop.run_in_executor(None, self.driver.shutdown)
        # every terminal event is now queued on the loop; let the open
        # streaming handlers flush them to their sockets before stopping —
        # bounded, so a stalled reader (full TCP window, frozen client)
        # cannot wedge the drain: past the grace its handler dies with the
        # loop, which is the same outcome the client forced anyway
        try:
            await asyncio.wait_for(self._streams_idle.wait(), timeout=STREAM_FLUSH_TIMEOUT_S)
        except asyncio.TimeoutError:
            pass
        self._stopped.set()

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

            # query strings arrive verbatim in the request-line path
            # (``/cache/keys?since=42``); routes match on the bare path
            path, _, query = path.partition("?")
            if method == "GET" and path == "/healthz":
                await self._handle_health(writer)
            elif method == "GET" and path == "/stats":
                await self._handle_stats(writer)
            elif method == "GET" and path == "/cache/keys":
                await self._handle_cache_keys(writer, query)
            elif method == "POST" and path == "/generate":
                await self._handle_generate(writer, payload)
            elif method == "POST" and path == "/cancel":
                await self._handle_cancel(writer, payload)
            elif method == "POST" and path == "/shutdown":
                await send_json(writer, 202, {"draining": True})
                asyncio.get_running_loop().create_task(self._drain_and_stop())
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

    def _routing_info(self) -> dict:
        """Static request-synthesis geometry the replica router needs to
        score payloads against this server's cache ring from another
        process (plus the pid, so a supervisor can identify the replica)."""
        f = self.factory
        return {
            "pid": os.getpid(),
            "ctx_len": f.ucfg.ctx_len,
            "ctx_dim": f.ucfg.ctx_dim,
            "timesteps_train": f.dcfg.timesteps_train,
            "max_steps": f.max_steps,
        }

    async def _handle_health(self, writer: asyncio.StreamWriter) -> None:
        eng = self.driver.engine
        await send_json(writer, 200, {
            "status": "draining" if self.driver.draining else "ok",
            "active": eng.n_active,
            "pending": eng.n_pending,
            "open": self.driver.open_requests,
            "max_inflight": self.driver.max_inflight,
            "lanes": eng.config.n_lanes,
            "shards": eng.config.n_shards,
            "mode": eng._mode_name,
            "pid": os.getpid(),
        })

    async def _handle_stats(self, writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        try:
            summary = await loop.run_in_executor(None, self.driver.stats)
        except TimeoutError:
            # the probe is pumped between micro-steps; the first request's
            # kernel build can outlast it — that's busy, not broken
            return await send_json(
                writer, 503, {"error": "stats probe timed out (engine busy)"}
            )
        summary = dict(summary, routing=self._routing_info())
        await send_json(writer, 200, summary)

    async def _handle_cache_keys(self, writer: asyncio.StreamWriter, query: str) -> None:
        """``GET /cache/keys[?since=N]`` — the incremental gossip channel:
        warm-slot key rows written after generation ``since`` plus the
        current ``version`` cursor (see ``SlotRing.key_delta``).  A
        cacheless engine answers an empty table, so pollers need no
        capability probe."""
        since = 0
        for part in query.split("&"):
            k, _, v = part.partition("=")
            if k == "since":
                try:
                    since = int(v)
                except ValueError:
                    return await send_json(
                        writer, 400, {"error": "since must be an integer generation"}
                    )
        loop = asyncio.get_running_loop()
        try:
            keys = await loop.run_in_executor(None, self.driver.cache_keys, since)
        except TimeoutError:
            return await send_json(
                writer, 503, {"error": "cache-keys probe timed out (engine busy)"}
            )
        await send_json(writer, 200, dict(keys, routing=self._routing_info()))

    async def _handle_cancel(self, writer: asyncio.StreamWriter, payload: dict) -> None:
        try:
            rid = int(payload["rid"])
        except (KeyError, TypeError, ValueError):
            return await send_json(writer, 400, {"error": "body must carry an int rid"})
        accepted = self.driver.cancel(rid)
        await send_json(writer, 200, {"accepted": accepted, "rid": rid})

    async def _handle_generate(self, writer: asyncio.StreamWriter, payload: dict) -> None:
        spec: RequestSpec | None = None
        try:
            reqs, gid, spec = self.factory.build(payload)
        except SchemaError as e:
            v1 = isinstance(payload, dict) and "task" not in payload
            hdrs = (DEPRECATION_HEADER,) if v1 else ()
            return await send_json(writer, 400, {"error": e.as_dict()}, hdrs)
        except (ValueError, TypeError) as e:
            # non-schema construction failure (e.g. policy resolution):
            # same structured shape, generic code
            return await send_json(
                writer, 400,
                {"error": {"code": "invalid", "field": "body", "detail": str(e)}},
            )
        hdrs = (DEPRECATION_HEADER,) if spec.v1 else ()
        stream_id = gid if gid is not None else reqs[0].rid

        loop = asyncio.get_running_loop()
        events: asyncio.Queue = asyncio.Queue()

        def on_event(ev: dict) -> None:  # driver thread -> event loop
            loop.call_soon_threadsafe(events.put_nowait, ev)

        try:
            if gid is not None:
                self.driver.submit_group(reqs, gid, on_event)
            else:
                self.driver.submit(reqs[0], on_event)
        except SubmitRejected as e:
            status = 503 if self.driver.draining else 429
            return await send_json(writer, status, {"error": str(e)}, hdrs)

        # both branches count as open streams so a drain never stops the
        # server loop before the terminal response reached the socket
        self._n_streams += 1
        self._streams_idle.clear()
        if not spec.stream:
            try:
                while True:
                    ev = await events.get()
                    if ev["event"] in TERMINAL_EVENTS:
                        return await send_json(writer, 200, ev, hdrs)
            finally:
                self._n_streams -= 1
                if self._n_streams == 0:
                    self._streams_idle.set()

        try:
            await start_chunked(writer, extra_headers=hdrs)
            while True:
                ev = await events.get()
                try:
                    writer.write(chunk((json.dumps(ev) + "\n").encode()))
                    await writer.drain()
                except (ConnectionError, OSError):
                    # client went away mid-denoise: stop burning lane-steps
                    # (a group id cancels every still-open variant)
                    self.driver.cancel(stream_id)
                    return
                if ev["event"] in TERMINAL_EVENTS:
                    break
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionError, OSError):
            self.driver.cancel(stream_id)
        finally:
            self._n_streams -= 1
            if self._n_streams == 0:
                self._streams_idle.set()
