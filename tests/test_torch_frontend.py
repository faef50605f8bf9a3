"""The port's HTTP front half against the JAX package's, and on its own.

* **Factory parity**: the same payloads (the four tasks, named and
  numeric quality, an explicit plan, img2img at two strengths, inpaint
  with a half and an explicit mask, K=3 variations, ``allow_cache:
  false``, a v1 payload) go through ``repro``'s and the port's
  ``RequestFactory``: ctx, noise, init latent and mask are bitwise equal;
  rids, plans, schedules, ``allow_cache`` and the resolved policies
  (float32 thresholds) are equal.
* **Slice parity**: those requests run through the JAX ``DiffusionEngine``
  and the port's (``eager``, CPU, ``cache_mode="cross"``, bridged weights):
  latents within 5e-4 (the engine tolerance of the JAX package's own
  differential tests), every cache counter equal, the published key rows
  and ``version`` equal.  The JAX engine runs once per module.
* **Driver protocol** on a driver that is not started (deterministic):
  backpressure, the event protocol, the digest against
  ``DiffusionEngine.run``, queued and in-lane cancels, refusal after drain.
* **Live HTTP** on the CPU: every v2 task, 429, the structured 400s, the v1
  ``Deprecation`` header, ``/stats``, ``/cache/keys``, a dropped stream,
  the drain; and ``python -m repro_torch.launch.serve --http`` driven by
  ``python -m repro_torch.serving.client`` in subprocesses.
"""
import ast
import asyncio
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.configs import get_unet_config as jget_unet_config
from repro.models import unet as JU
from repro.serving import config as JCFG
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.frontend import RequestFactory as JRequestFactory
from repro_torch import bridge
from repro_torch import kernels as K
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import get_unet_config
from repro_torch.launch import serve as SERVE
from repro_torch.serving import config as CFG
from repro_torch.serving.client import (
    FrontendClient,
    RequestRejected,
    _read_body,
    _read_response_head,
)
from repro_torch.serving.driver import EngineDriver, SubmitRejected, latent_digest
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.frontend import HTTPFrontend, RequestFactory
from repro_torch.serving.schema import SchemaError

JTOY = jget_unet_config("sd_toy")
TOY = get_unet_config("sd_toy")
L = TOY.latent_size**2
MAX_STEPS = 8
TOL = 5e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(n_lanes=2, max_steps=MAX_STEPS, l_sketch=3, l_refine=2, decode_images=False,
              cache_mode="cross")
#: the slice-parity engine: one lane, so requests run one after another and
#: each request's cache hits can be told apart; two buckets, so a shorter
#: schedule's planned SKETCH steps land in buckets a longer one captured
SLICE = dict(ENGINE, n_lanes=1, cache_t_bucket=500)
#: counters that must be equal between the two engines
COUNTERS = (
    "full_steps", "sketch_steps", "refine_steps", "demoted_full_steps",
    "demoted_sketch_steps", "cache_hit_rate", "cache_probes", "cache_probe_hits",
    "cache_inserts", "cache_evictions", "cache_warm_slots", "micro_steps",
    "lane_steps_advanced", "quality_mix",
)
CAT = dict(prompt="cat", seed=1, timesteps=MAX_STEPS, quality="balanced")
DRAFT = dict(prompt="cat", seed=7, timesteps=MAX_STEPS, quality="draft")
PAYLOADS = [
    {"task": "txt2img", **CAT},
    # the same payload again: its steps hit the first one's slots (cross
    # mode); the opted-out copy's never do
    {"task": "txt2img", **CAT},
    {"task": "txt2img", **CAT, "allow_cache": False},
    {"task": "img2img", "prompt": "dog", "seed": 2, "timesteps": 8, "init": {"seed": 5},
     "strength": 0.4},
    {"task": "txt2img", **DRAFT},
    {"task": "img2img", "prompt": "dog", "seed": 3, "timesteps": 8, "init": {"seed": 5},
     "strength": 0.75, "quality": "high"},
    # the draft prompt over 7 steps: its planned SKETCH steps land in buckets
    # the 8-step run captured, so they run as REFINE
    {"task": "txt2img", **DRAFT, "timesteps": 7},
    {"task": "inpaint", "prompt": "fox", "seed": 4, "timesteps": 6, "init": {"seed": 6},
     "mask": {"kind": "half"}},
    {"task": "inpaint", "prompt": "fox", "seed": 5, "timesteps": 6, "init": {"seed": 6},
     "mask": {"kind": "explicit", "values": [(i % 4) / 3 for i in range(L)]}},
    {"task": "variations", "prompt": "owl", "seed": 6, "timesteps": 6, "variants": 3,
     "quality": "draft"},
    {"task": "txt2img", "prompt": "cat", "seed": 8, "timesteps": 8, "quality": "exact"},
    {"task": "txt2img", "prompt": "eel", "seed": 9, "timesteps": 7, "quality": 0.3},
    {"task": "txt2img", "prompt": "eel", "seed": 10, "timesteps": 8,
     "plan": {"t_sketch": 4, "t_complete": 2, "t_sparse": 2}},
    {"prompt": "v1", "seed": 11, "timesteps": 5, "pas": True},
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _factories():
    jcfg = JEngineConfig(**ENGINE)
    tcfg = EngineConfig(**ENGINE, device="cpu")
    return (JRequestFactory(JTOY, JDiffusionConfig(timesteps_sample=MAX_STEPS), jcfg),
            RequestFactory(TOY, DiffusionConfig(timesteps_sample=MAX_STEPS), tcfg))


def _build_all(factory) -> list:
    return [factory.build(p) for p in PAYLOADS]


def _arrays(req) -> dict:
    return {k: getattr(req, k) for k in ("ctx", "noise", "init_latent", "mask")}


def test_factory_builds_bitwise_equal_requests():
    jf, tf = _factories()
    assert tf.backend == "eager"
    for payload, (jreqs, jgid, jspec), (treqs, tgid, tspec) in zip(
        PAYLOADS, _build_all(jf), _build_all(tf)
    ):
        assert (tgid, dataclasses.asdict(tspec)) == (jgid, dataclasses.asdict(jspec)), payload
        assert len(treqs) == len(jreqs)
        for j, t in zip(jreqs, treqs):
            for name, ref in _arrays(j).items():
                got = _arrays(t)[name]
                if ref is None:
                    assert got is None, name
                else:
                    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), name
            assert (t.rid, t.timesteps, t.base_timesteps, t.allow_cache) == (
                j.rid, j.timesteps, j.base_timesteps, j.allow_cache)
            assert dataclasses.asdict(t.policy) == dataclasses.asdict(j.policy), payload
            for step in (0, 250, 999):
                assert t.policy.threshold_for(step, 0.15) == j.policy.threshold_for(step, 0.15)


def test_factory_refusals_are_typed_alike():
    jf, tf = _factories()
    for bad in (
        {"task": "img2img", "timesteps": 4},
        {"task": "txt2img", "quality": "exact", "plan": {"t_sketch": 2, "t_complete": 1,
                                                         "t_sparse": 2}},
        {"task": "txt2img", "plan": {"t_sketch": 2}},
        {"task": "txt2img", "plan": {"t_sketch": 2, "t_complete": 1, "t_sparse": 2, "x": 1}},
        {"task": "txt2img", "timesteps": 4, "plan": {"t_sketch": 9, "t_complete": 1,
                                                     "t_sparse": 2}},
        {"task": "inpaint", "init": {"seed": 1}, "mask": {"kind": "explicit", "values": [1.0]}},
    ):
        errs = []
        for f in (jf, tf):
            with pytest.raises(ValueError) as ei:
                f.build(bad)
            e = ei.value
            errs.append((e.code, e.field) if hasattr(e, "code") else type(e).__name__)
        assert errs[1] == errs[0], bad
    # the kernels assertion: the port's factory accepts its own backend only
    with pytest.raises(SchemaError) as ei:
        tf.build({"task": "txt2img", "kernels": "cuda"})
    assert (ei.value.code, ei.value.field) == ("forbidden", "kernels")
    assert tf.build({"task": "txt2img", "kernels": "eager"})[0][0].timesteps == MAX_STEPS


# ---------------------------------------------------------------------------
# Slice parity: the factory's requests through both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jparams = jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(0), JTOY)
    return jparams, bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.fixture(scope="module")
def served(weights):
    """(JAX run, port run): each {rid: latent}, the summary, the key delta,
    the key summary; and the port's cache hits by rid."""
    jf, tf = _factories()
    jengine = JCFG.build_engine(JEngineConfig(**SLICE), models=(
        JTOY, JDiffusionConfig(timesteps_sample=MAX_STEPS), weights[0], None)).engine
    done, summary = jengine.run([r for rs, _, _ in _build_all(jf) for r in rs])
    ref = ({d.rid: np.asarray(d.latent) for d in done}, summary,
           jengine.cache.keys_delta(0), jengine.cache.slots_summary())
    # the port's engine stepped by hand (as run() steps it), so the hits
    # between two retirements are the one lane's request's
    engine = CFG.build_engine(EngineConfig(**SLICE, device="cpu"), models=(
        TOY, DiffusionConfig(timesteps_sample=MAX_STEPS), weights[1], None)).engine
    for req in [r for rs, _, _ in _build_all(tf) for r in rs]:
        engine.submit(req)
    latents, hits, seen = {}, {}, 0
    while engine.n_pending or engine.n_active:
        for d in engine.step():
            latents[d.rid] = d.latent
            hits[d.rid], seen = engine.cache.probe_hits - seen, engine.cache.probe_hits
    got = (latents, dict(engine.metrics.summary(), **engine.cache.stats()),
           engine.cache.keys_delta(0), engine.cache.slots_summary())
    return ref, got, hits


def test_slice_latents_match_jax(served):
    (ref, _, _, _), (got, _, _, _), _ = served
    assert sorted(got) == sorted(ref) and len(got) == 16
    for rid in ref:
        assert got[rid].dtype == np.float32 and got[rid].flags.c_contiguous
        np.testing.assert_allclose(got[rid], ref[rid], atol=TOL, rtol=0, err_msg=f"rid={rid}")


def test_slice_counters_and_published_keys_equal_jax(served):
    (_, ref, ref_keys, ref_summary), (_, got, got_keys, got_summary), _ = served
    assert {k: got[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}
    assert got["demoted_full_steps"] > 0 and got["demoted_sketch_steps"] > 0
    assert got_keys == ref_keys and got_summary == ref_summary
    assert got_keys["version"] == got["cache_inserts"] > 0
    rows = got_keys["rings"][0]
    assert rows and all(0 < r["gen"] <= got_keys["version"] for r in rows)


def test_allow_cache_false_gets_no_hit_where_its_twin_does(served):
    (ref, _, _, _), (got, _, _, _), hits = served
    # rids 0-2: the payload, its twin, its opted-out copy, one after another
    assert hits[1] > 0 and hits[0] == hits[2] == 0
    # opted out, it ran every step as the first one did
    assert got[2].tobytes() == got[0].tobytes() and ref[2].tobytes() == ref[0].tobytes()


# ---------------------------------------------------------------------------
# Driver protocol (the port's engine alone)
# ---------------------------------------------------------------------------


@pytest.fixture
def engine():
    """A fresh engine per test (cheap at sd_toy): metrics and cache start cold."""
    return CFG.build_engine(EngineConfig(**ENGINE, device="cpu")).engine


def _factory() -> RequestFactory:
    return RequestFactory(TOY, DiffusionConfig(timesteps_sample=MAX_STEPS),
                          EngineConfig(**ENGINE, device="cpu"))


def _req(f: RequestFactory, **payload):
    (req,), _, _ = f.build(dict({"task": "txt2img", "timesteps": 3}, **payload))
    return req


class _Collector:
    """Thread-safe event sink with per-rid terminal latches."""

    def __init__(self):
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._terminal: dict[int, threading.Event] = {}

    def sink(self, rid: int):
        with self._lock:
            self._terminal.setdefault(rid, threading.Event())

        def on_event(ev):
            with self._lock:
                self.events.append(ev)
            if ev["event"] in ("done", "cancelled", "error"):
                self._terminal[ev["rid"]].set()

        return on_event

    def wait(self, rid: int, timeout=120.0):
        assert self._terminal[rid].wait(timeout), f"rid {rid} never reached terminal"

    def of(self, rid: int) -> list[dict]:
        with self._lock:
            return [e for e in self.events if e.get("rid") == rid]


def test_driver_backpressure_and_refusal_after_drain(engine):
    f, col = _factory(), _Collector()
    driver = EngineDriver(engine, max_inflight=2)  # not started: deterministic
    r0, r1, r2 = _req(f), _req(f), _req(f)
    driver.submit(r0, col.sink(r0.rid))
    driver.submit(r1, col.sink(r1.rid))
    with pytest.raises(SubmitRejected):
        driver.submit(r2, col.sink(r2.rid))
    assert driver.n_rejected == 1
    driver.start()
    col.wait(r0.rid)
    col.wait(r1.rid)
    r3 = _req(f)
    driver.submit(r3, col.sink(r3.rid))  # capacity freed by completion
    col.wait(r3.rid)
    summary = driver.shutdown(timeout=120)
    assert summary["completed"] == 3 and summary["drained"] and summary["rejected"] == 1
    assert summary["kernels"] == "eager" and summary["mode"] == "continuous"
    with pytest.raises(SubmitRejected):
        driver.submit(_req(f))
    assert driver.shutdown() == summary  # idempotent


def test_driver_event_protocol_and_digest_equal_engine_run(engine):
    payload = dict(prompt="digest", seed=7, timesteps=5, quality="exact")
    digests = []
    for _ in range(2):
        f, col = _factory(), _Collector()
        driver = EngineDriver(engine, max_inflight=4)
        req = _req(f, **payload)
        driver.submit(req, col.sink(req.rid))
        driver.start()
        col.wait(req.rid)
        driver.shutdown(timeout=120)
        evs = col.of(req.rid)
        kinds = [e["event"] for e in evs]
        assert kinds[0] == "queued" and evs[0]["kernels"] == "eager"
        assert [e["step"] for e in evs if e["event"] == "step"] == [1, 2, 3, 4, 5]
        assert kinds[-1] == "done" and sum(k in ("done", "cancelled", "error") for k in kinds) == 1
        assert evs[-1]["steps"] == 5 and evs[-1]["latency_s"] > 0
        digests.append(evs[-1]["latent_digest"])
    done, _ = engine.run([_req(_factory(), **payload)])
    assert digests[0] == digests[1] == latent_digest(done[0].latent)


def test_driver_cancels_queued_and_in_lane_requests(engine):
    f, col = _factory(), _Collector()
    driver = EngineDriver(engine, max_inflight=8)
    stepped = threading.Event()
    reqs = [_req(f, timesteps=8), _req(f, timesteps=8), _req(f), _req(f)]

    def watch(base):
        def on_event(ev):
            if ev["event"] == "step":
                stepped.set()
            base(ev)
        return on_event

    driver.submit(reqs[0], watch(col.sink(reqs[0].rid)))
    for r in reqs[1:]:
        driver.submit(r, col.sink(r.rid))
    assert driver.cancel(reqs[3].rid)  # still in the inbox: no lane touched
    driver.start()
    assert stepped.wait(120), "the first request never advanced"
    assert driver.cancel(reqs[0].rid)
    for r in reqs:
        col.wait(r.rid)
    queued, lane = col.of(reqs[3].rid)[-1], col.of(reqs[0].rid)[-1]
    assert queued["event"] == "cancelled" and queued["where"] == "queue"
    assert lane["event"] == "cancelled" and lane["where"] == "lane" and lane["at_step"] >= 1
    summary = driver.shutdown(timeout=120)
    assert summary["completed"] == 2 and summary["cancelled"] == 2 and summary["drained"]
    assert not driver.cancel(reqs[3].rid)  # unknown now


# ---------------------------------------------------------------------------
# Live HTTP, in process
# ---------------------------------------------------------------------------


async def _raw(client, method, path, payload=None):
    """One request, returning (status, headers, body)."""
    body = json.dumps(payload or {}).encode()
    reader, writer = await client._connect()
    try:
        writer.write(client._head(method, path, body))
        await writer.drain()
        status, headers = await _read_response_head(reader)
        return status, headers, json.loads((await _read_body(reader, headers)) or b"{}")
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _serve(driver):
    frontend = HTTPFrontend(driver, _factory(), "127.0.0.1", 0)
    await frontend.start()
    task = asyncio.create_task(frontend.serve_until_shutdown())
    return FrontendClient("127.0.0.1", frontend.port), task


def test_http_v2_tasks_stats_keys_and_drain(engine):
    async def scenario():
        client, serve_task = await _serve(EngineDriver(engine, max_inflight=8).start())
        health = await client.health()
        assert health["status"] == "ok" and health["lanes"] == 2 and health["max_inflight"] == 8
        done = await client.generate(task="txt2img", prompt="http", seed=1, timesteps=4,
                                     quality="draft", kernels="eager")
        assert done["event"] == "done" and done["steps"] == 4
        done = await client.generate(task="img2img", prompt="http", seed=2, timesteps=6,
                                     init={"seed": 11}, strength=0.4)
        assert done["event"] == "done" and done["steps"] == 2  # round(0.4 * 6)
        done = await client.generate(task="inpaint", prompt="http", seed=3, timesteps=4,
                                     init={"seed": 12}, mask={"kind": "half"})
        assert done["event"] == "done" and done["steps"] == 4
        events = [ev async for ev in client.generate_stream(
            task="variations", prompt="http", seed=4, timesteps=4, variants=3)]
        assert events[0]["event"] == "queued" and events[0]["variants"] == 3
        assert sorted(e["variant"] for e in events if e["event"] == "variant_done") == [0, 1, 2]
        term = events[-1]
        assert term["event"] == "done" and len(term["variant_digests"]) == 3
        assert all(term["variant_digests"]) and term["latent_digest"]

        stats = await client.stats()
        assert stats["kernels"] == "eager" and stats["mode"] == "continuous"
        assert stats["quality_mix"] == {"draft": 1, "full": 5}
        assert stats["accepted"] == stats["completed"] == 6
        assert "eager" in stats["step_time_by_backend"]
        assert stats["cache_slots_summary"]["version"] > 0
        keys = await client.cache_keys(0)
        assert keys["rings"][0] and keys["version"] == stats["cache_slots_summary"]["version"]
        assert all(0 < r["gen"] <= keys["version"] for r in keys["rings"][0])
        later = await client.cache_keys(keys["version"])
        assert later["rings"] == [[]] and later["since"] == keys["version"]
        assert keys["routing"]["max_steps"] == MAX_STEPS
        status, _, body = await _raw(client, "GET", "/cache/keys?since=x")
        assert status == 400 and "since" in body["error"]
        status, _, body = await _raw(client, "GET", "/nowhere")
        assert status == 404

        assert (await client.shutdown()) == {"draining": True}
        summary = await serve_task
        assert summary["drained"] and summary["open"] == 0 and summary["completed"] == 6

    asyncio.run(scenario())
    assert engine.n_active == 0 and engine.n_pending == 0


def test_http_429_structured_400s_and_v1_header(engine):
    async def scenario():
        driver = EngineDriver(engine, max_inflight=1)  # not started: requests stay open
        client, serve_task = await _serve(driver)
        first = asyncio.create_task(client.generate(task="txt2img", timesteps=3))
        for _ in range(200):
            if (await client.health())["open"] == 1:
                break
            await asyncio.sleep(0.02)
        with pytest.raises(RequestRejected) as exc:
            await client.generate(task="txt2img", timesteps=3)
        assert exc.value.status == 429
        # v2 refusals: the structured body, no Deprecation header
        status, headers, body = await _raw(client, "POST", "/generate",
                                           {"task": "img2img", "timesteps": 4})
        assert status == 400 and "deprecation" not in headers
        assert {k: body["error"][k] for k in ("code", "field")} == {"code": "missing",
                                                                    "field": "init"}
        status, _, body = await _raw(client, "POST", "/generate",
                                     {"task": "txt2img", "kernels": "cuda"})
        assert status == 400 and body["error"]["code"] == "forbidden"
        status, _, body = await _raw(client, "POST", "/generate",
                                     {"task": "txt2img", "kernels": "xla"})
        assert status == 400 and body["error"] == {
            "code": "invalid", "field": "kernels", "detail": body["error"]["detail"]}
        status, headers, _ = await _raw(client, "POST", "/generate", {"timesteps": 0})
        assert status == 400 and headers.get("deprecation") == 'version="v1"'
        status, _, body = await _raw(client, "POST", "/cancel", {"rid": "x"})
        assert status == 400

        driver.start()
        done = await first
        assert done["event"] == "done" and done["latent_digest"]
        # a v1 flat payload is served, flagged deprecated
        status, headers, body = await _raw(
            client, "POST", "/generate", {"prompt": "v1", "seed": 5, "timesteps": 3,
                                          "stream": False})
        assert status == 200 and body["event"] == "done"
        assert headers.get("deprecation") == 'version="v1"'
        await client.shutdown()
        summary = await serve_task
        assert summary["drained"] and summary["rejected"] == 1 and summary["completed"] == 2

    asyncio.run(scenario())


def test_http_dropped_stream_cancels_its_request(engine):
    async def scenario():
        client, serve_task = await _serve(EngineDriver(engine, max_inflight=8).start())
        body = json.dumps({"task": "txt2img", "timesteps": MAX_STEPS}).encode()
        reader, writer = await client._connect()
        writer.write(client._head("POST", "/generate", body))
        await writer.drain()
        await _read_response_head(reader)
        await reader.readline()  # the first chunk: the queued event
        writer.close()  # the client goes away mid-denoise
        for _ in range(600):
            stats = await client.stats()
            if stats["open"] == 0:
                break
            await asyncio.sleep(0.05)
        assert stats["cancelled"] == 1 and stats["completed"] == 0 and stats["open"] == 0
        await client.shutdown()
        summary = await serve_task
        assert summary["drained"]

    asyncio.run(scenario())


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_http_engine_failure_errors_open_streams_and_stops_the_server(engine):
    """A kernel's exception on the driver thread is not swallowed: every
    open stream gets its ``error`` event and the server shuts down with
    the error in its summary."""
    step = engine.step

    def failing_step(*args, **kwargs):
        if engine.metrics.micro_steps >= 2:
            raise RuntimeError("kernel launch failed")
        return step(*args, **kwargs)

    engine.step = failing_step

    async def scenario():
        client, serve_task = await _serve(EngineDriver(engine, max_inflight=8).start())
        events = [ev async for ev in client.generate_stream(task="txt2img", timesteps=6)]
        assert [e["event"] for e in events[:1]] == ["queued"]
        assert events[-1]["event"] == "error" and "kernel launch failed" in events[-1]["error"]
        summary = await asyncio.wait_for(serve_task, 60)
        assert "kernel launch failed" in summary["error"] and not summary["drained"]

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# The CLI in subprocesses
# ---------------------------------------------------------------------------


def _env() -> dict:
    # one thread a process: a multi-threaded torch in a crowded test worker spins
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_from_args_reads_quality_and_max_inflight():
    args = SERVE.build_parser().parse_args(
        ["--device", "cpu", "--http", "127.0.0.1:0", "--quality", "draft", "--max-inflight", "3"])
    cfg = CFG.from_args(args, decode_images=False)
    assert (cfg.quality, cfg.max_inflight, cfg.decode_images) == ("draft", 3, False)
    assert SERVE._parse_hostport(args.http) == ("127.0.0.1", 0)


def test_serve_http_and_client_cli(tmp_path):
    port_file = str(tmp_path / "http.port")
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--batch", "2",
         "--timesteps", "4", "--cache", "cross", "--quality", "draft", "--max-inflight", "3",
         "--http", "127.0.0.1:0", "--port-file", port_file],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO,
    )
    try:
        client = subprocess.run(
            [sys.executable, "-m", "repro_torch.serving.client", "--port-file", port_file,
             "--requests", "2", "--concurrency", "2", "--t-lo", "3", "--t-hi", "4",
             "--shutdown"],
            capture_output=True, text=True, timeout=120, env=_env(), cwd=REPO,
        )
        assert client.returncode == 0, client.stderr[-2000:] + client.stdout[-2000:]
        assert "'max_inflight': 3" in client.stdout
        out, err = server.communicate(timeout=120)
        assert server.returncode == 0, err[-2000:]
        assert "'drained': True" in out and "'quality_mix': {'draft': 2}" in out
        assert "'kernels': 'eager'" in out
        # the drained line carries the serving run's launch counts (the chip
        # smoke test reads them there); an eager CPU server launches nothing
        launches = re.search(r"\[serve\] drained .*'launches': (\{[^{}]*\})", out)
        assert launches
        assert ast.literal_eval(launches.group(1)) == dict.fromkeys(K.KERNEL_REGISTRY, 0)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()


@pytest.mark.parametrize("flags,error,message", [
    (["--device", "cpu", "--engine", "static"], SystemExit, "--http requires the continuous"),
    ([], RuntimeError, "none is available"),  # no GPU and no --device cpu: no fallback
])
def test_serve_http_refusals_bind_no_port(tmp_path, flags, error, message):
    if not flags and torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the server would start on it")
    port_file = tmp_path / "http.port"
    with pytest.raises(error, match=message):
        SERVE.main(["--http", "127.0.0.1:0", "--port-file", str(port_file), *flags])
    assert not port_file.exists()
