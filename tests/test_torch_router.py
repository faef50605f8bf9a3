"""The port's replica router against the JAX package's, and live on the CPU.

* **Pure policy, bitwise equal to ``repro``'s** (``repro.serving.router``
  and ``repro.runtime.fault_tolerance`` import no JAX, so the reference is
  cheap): ``request_signature`` (also against the port's own
  ``RequestFactory`` context pooled by ``cache.prompt_signature``),
  ``signature_distance`` (also against ``cache.signature_distance``),
  ``visited_buckets`` (also against the buckets the port's engine visits
  for the same request), ``payload_warmth`` on the reference tests'
  synthetic, truncated and annotated summaries, ``pick_replica`` over
  random load/warmth vectors, ``RestartBackoff`` and ``StragglerDetector``.
* **Gossip mirror**: the same ``/cache/keys`` deltas through both packages'
  ``ReplicaHandle`` give equal ``gossip_summary`` outputs.
* **Warmth on a live summary** of a port engine that served one request.
* **The gateway imports no torch**, and **never falls back to the CPU**.
* **One fleet on the CPU** (2 sd_toy replicas): a SIGKILL mid-request,
  the failover's digest against an in-process engine built from the same
  flags, the respawn, the client CLI's ``--router`` checks, the drain.
"""
import asyncio
import contextlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - bare container
    from _hypothesis_fallback import given, settings, st

from repro.runtime import fault_tolerance as JFT
from repro.serving import router as JR
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import get_unet_config
from repro_torch.launch import router as LR
from repro_torch.launch import serve as SERVE
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.serving import cache as C
from repro_torch.serving import config as CFG
from repro_torch.serving import router as R
from repro_torch.serving.client import FrontendClient
from repro_torch.serving.driver import latent_digest
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.frontend import HTTPFrontend, RequestFactory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = get_unet_config("sd_toy")
MAX_STEPS = 8
ENGINE = dict(n_lanes=2, max_steps=MAX_STEPS, l_sketch=3, l_refine=2, decode_images=False,
              cache_mode="cross", device="cpu")
#: the reference tests' routing geometry
ROUTING = {"ctx_len": 8, "ctx_dim": 32, "timesteps_train": 1000, "max_steps": 8}
#: the fleet's engine flags, for every replica and for the in-process reference
FLEET = ["--device", "cpu", "--batch", "2", "--timesteps", "4", "--cache", "cross",
         "--max-inflight", "8"]
#: the fleet test's bound on each of its waits
WAIT_S = 120


def _env() -> dict:
    # one thread per process: the replicas and the in-process reference run
    # the same float32 sums in the same order, and the shared CPU stays free
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the CPU, and torch's
    spinning thread pool slows a crowded worker many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _factory(engine_config: EngineConfig) -> RequestFactory:
    return RequestFactory(TOY, DiffusionConfig(timesteps_sample=engine_config.max_steps),
                          engine_config)


def _both(fn_name: str, *args, **kwargs):
    return getattr(R, fn_name)(*args, **kwargs), getattr(JR, fn_name)(*args, **kwargs)


# ---------------------------------------------------------------------------
# Pure policy
# ---------------------------------------------------------------------------

PROMPTS = ["", "a cat in a hat", "ünïcode prompt ✓", "x" * 300]


@pytest.mark.parametrize("seed", [0, 4242, (1 << 30) - 1])
@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_request_signature_equals_reference_and_factory(prompt, seed):
    payload = {"task": "txt2img", "prompt": prompt, "seed": seed, "timesteps": 4}
    for ctx_len, ctx_dim in ((8, 32), (TOY.ctx_len, TOY.ctx_dim), (77, 768)):
        got, ref = _both("request_signature", payload, ctx_len, ctx_dim)
        assert got.dtype == ref.dtype == np.float32 and got.tobytes() == ref.tobytes()
    # the signature the replica's factory will key its cache slots with
    (req,), _, _ = _factory(EngineConfig(**ENGINE)).build(payload)
    want = C.prompt_signature(req.ctx)
    got = R.request_signature(payload, TOY.ctx_len, TOY.ctx_dim)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_signature_distance_equals_cache_and_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=32).astype(np.float32)
    for b in (rng.normal(size=32).astype(np.float32), a * 1.001, np.zeros(32, np.float32),
              list(map(float, a + 0.1))):
        got = R.signature_distance(a, b)
        assert got == JR.signature_distance(a, b) == C.signature_distance(a, b)


BUCKET_CASES = [
    (t, task, strength, t_bucket)
    for t in (1, 4, 7, 8)
    for task, strength in (("txt2img", None), ("inpaint", None), ("img2img", 0.4),
                           ("img2img", 0.75), ("img2img", 1.0))
    for t_bucket in (125, 500)
]


def _payload(timesteps, task, strength=None, **extra) -> dict:
    p = {"task": task, "prompt": "bucket", "seed": 1, "timesteps": timesteps, **extra}
    if task in ("img2img", "inpaint"):
        p["init"] = {"seed": 2}
    if task == "inpaint":
        p["mask"] = {"kind": "half"}
    if strength is not None:
        p["strength"] = strength
    return p


@pytest.mark.parametrize("timesteps,task,strength,t_bucket", BUCKET_CASES)
def test_visited_buckets_equal_reference(timesteps, task, strength, t_bucket):
    payload = _payload(timesteps, task, strength)
    got, ref = _both("visited_buckets", payload, ROUTING, t_bucket)
    assert got == ref
    assert R.visited_buckets({}, ROUTING, t_bucket) == JR.visited_buckets({}, ROUTING, t_bucket)


@pytest.fixture(scope="module")
def bucket_engine():
    """A port engine whose cache is only asked for its bucket width."""
    cfg = EngineConfig(**ENGINE)
    bundle = CFG.build_engine(cfg)
    factory = RequestFactory(bundle.ucfg, bundle.dcfg, cfg, policy=bundle.policy)
    return bundle.engine, factory, HTTPFrontend(None, factory)._routing_info()


@pytest.mark.parametrize("timesteps,task,strength", sorted(
    {(t, task, s) for t, task, s, _ in BUCKET_CASES}, key=str))
def test_visited_buckets_are_the_ones_the_engine_visits(bucket_engine, timesteps, task,
                                                        strength):
    engine, factory, routing = bucket_engine
    payload = _payload(timesteps, task, strength)
    (req,), _, _ = factory.build(payload)
    engine.submit(req)  # resolves the request's lane plan (never stepped)
    ts = req._lane_plan.ts[: req.timesteps]
    want = (req.sched_offset, sorted({engine.cache.bucket_of(int(t)) for t in ts}))
    assert R.visited_buckets(payload, routing, engine.cache.t_bucket) == want


def _slots(mode="cross", threshold=0.5, t_bucket=125, slots=()):
    return {"mode": mode, "threshold": threshold, "t_bucket": t_bucket, "rings": [list(slots)]}


def _slot(bucket, sig, offset=0, rid=0, **extra):
    return {"bucket": bucket, "offset": offset, "rid": rid, "sig": list(map(float, sig)),
            **extra}


def _warmth_cases():
    """(payload, summary, expected warmth): the reference tests' cases."""
    p = {"prompt": "routing target", "seed": 77, "timesteps": 4}
    sig = R.request_signature(p, 8, 32)
    warm = [_slot(b, sig) for b in (0, 2, 4, 6)]
    truncated = _slots(slots=[_slot(0, sig, slot=3, gen=41)])
    truncated.update(version=41, truncated=True)
    i2i = {"prompt": "routing target", "seed": 77, "timesteps": 4, "task": "img2img",
           "strength": 0.5}
    return [
        (p, _slots(mode="intra", slots=warm), 0.0),
        (p, _slots(threshold=0.0, slots=warm), 0.0),
        (p, _slots(slots=[]), 0.0),
        (p, {}, 0.0),
        (p, _slots(slots=[_slot(0, sig), _slot(4, sig), _slot(2, sig, offset=1)]), 0.5),
        (p, _slots(slots=[_slot(0, sig + 10.0)]), 0.0),
        (p, _slots(slots=[_slot(0, sig * 1.001)]), 0.25),
        (p, _slots(slots=warm), 1.0),
        (p, _slots(slots=[_slot(b, sig + 50.0) for b in (0, 2, 4, 6)]), 0.0),
        (p, truncated, 0.25),
        (i2i, _slots(slots=[_slot(0, sig, offset=2), _slot(2, sig, offset=2)]), 1.0),
        (i2i, _slots(slots=warm), 0.0),
    ]


@pytest.mark.parametrize("case", range(len(_warmth_cases())))
def test_payload_warmth_equals_reference(case):
    payload, summary, expected = _warmth_cases()[case]
    got, ref = _both("payload_warmth", payload, ROUTING, summary)
    assert got == ref == pytest.approx(expected)
    assert R.payload_warmth(payload, {}, summary) == 0.0


@settings(max_examples=200, deadline=None)
@given(
    st.lists(st.tuples(st.floats(0, 2), st.floats(0, 1)), max_size=6),
    st.floats(0, 2),
    st.booleans(),
)
def test_pick_replica_equals_reference(pairs, weight, cold):
    loads = [a for a, _ in pairs]
    warmths = None if cold else [w for _, w in pairs]
    assert R.pick_replica(loads, warmths, weight) == JR.pick_replica(loads, warmths, weight)
    assert R.pick_replica(loads) == JR.pick_replica(loads)


@pytest.mark.parametrize("kwargs", [{}, dict(base_s=1.0, max_s=8.0),
                                    dict(base_s=0.1, factor=3.0, max_s=5.0),
                                    dict(base_s=2.0, factor=1.0, max_s=2.0)])
def test_restart_backoff_equals_reference(kwargs):
    got, ref = FT.RestartBackoff(**kwargs), JFT.RestartBackoff(**kwargs)
    for _ in range(2):
        assert [got.next_delay() for _ in range(9)] == [ref.next_delay() for _ in range(9)]
        got.reset()
        ref.reset()
    h = R.ReplicaHandle(0, ["true"], "/nonexistent", backoff=FT.RestartBackoff(**kwargs))
    assert h.backoff.next_delay() == FT.RestartBackoff(**kwargs).base_s


@pytest.mark.parametrize("kwargs", [dict(base_s=0), dict(factor=0.5), dict(base_s=2, max_s=1)])
def test_restart_backoff_refuses_like_reference(kwargs):
    for cls in (FT.RestartBackoff, JFT.RestartBackoff):
        with pytest.raises(ValueError):
            cls(**kwargs)


@pytest.mark.parametrize("seed", range(3))
def test_straggler_detector_equals_reference(seed):
    rng = np.random.default_rng(seed)
    dts = rng.uniform(0.05, 0.1, size=60)
    dts[rng.choice(60, size=6, replace=False)] *= rng.uniform(1.5, 6.0, size=6)
    got, ref = FT.StragglerDetector(), JFT.StragglerDetector()
    flags = [(got.observe(i, float(dt)), ref.observe(i, float(dt))) for i, dt in enumerate(dts)]
    assert all(a == b for a, b in flags) and any(a for a, _ in flags)
    assert got.flagged == ref.flagged and got.mean == ref.mean and got.count == ref.count
    # probe round trips below the floor are clamped up to it
    rtts = [1e-6] * 10 + [0.09, 0.2] + list(dts)
    got, ref = (cls(0, ["true"], "/nonexistent") for cls in (R.ReplicaHandle, JR.ReplicaHandle))
    flags = [got.observe_probe(r) for r in rtts]
    assert flags == [ref.observe_probe(r) for r in rtts] and flags[10:12] == [False, True]


# ---------------------------------------------------------------------------
# Gossip mirror
# ---------------------------------------------------------------------------


def _fake_keys_handle(cls, deltas):
    """A ``cls`` handle whose ``/cache/keys`` endpoint is a scripted queue
    (no subprocess, no socket); the ``since`` arguments are recorded."""

    class Fake(cls):
        seen_since: list

        @property
        def ready(self) -> bool:
            return True

        def client(self):
            outer = self

            class _C:
                async def cache_keys(self, since: int = 0):
                    outer.seen_since.append(int(since))
                    return dict(outer.deltas.pop(0))

            return _C()

    h = Fake(0, ["true"], "/nonexistent")
    h.deltas, h.seen_since = list(deltas), []
    return h


def _delta(version, rows, **meta):
    return {"mode": "cross", "threshold": 0.5, "t_bucket": 125, **meta,
            "version": version, "rings": [rows]}


def _row(slot, gen, bucket, sig, rid=0, offset=0):
    return {"slot": slot, "gen": gen, "bucket": bucket, "offset": offset, "rid": rid,
            "sig": list(map(float, sig))}


SIG = np.linspace(-1, 1, 4)
GOSSIP = {
    "merge by slot": [
        _delta(5, [_row(0, 4, 1, SIG), _row(1, 5, 2, SIG)]),
        _delta(9, [_row(1, 9, 7, SIG, rid=3), _row(2, 8, 4, SIG)]),
    ],
    "version regression": [
        _delta(7, [_row(0, 7, 1, SIG), _row(3, 6, 9, SIG)]),
        _delta(2, [_row(0, 2, 5, SIG)]),  # regression trips the reset...
        _delta(2, [_row(1, 2, 6, SIG)]),  # ...and this full refetch wins
    ],
    "empty then meta change": [
        _delta(0, []),
        _delta(3, [_row(0, 3, 0, SIG, offset=2)], threshold=0.25, t_bucket=500),
        _delta(3, []),
        _delta(4, [_row(0, 4, 1, SIG * 2)], mode="intra"),
    ],
}


@pytest.mark.parametrize("name", sorted(GOSSIP))
def test_gossip_mirror_equals_reference(name):
    got, ref = (_fake_keys_handle(cls, GOSSIP[name]) for cls in (R.ReplicaHandle,
                                                                 JR.ReplicaHandle))
    assert got.gossip_summary() == ref.gossip_summary() == {}
    while got.deltas:
        assert asyncio.run(got.refresh_keys()) == asyncio.run(ref.refresh_keys())
        assert got.gossip_summary() == ref.gossip_summary()
        assert (got.keys_version, got.seen_since) == (ref.keys_version, ref.seen_since)
    assert not ref.deltas
    if name == "version regression":
        assert got.seen_since == [0, 7, 0]
        assert [r["slot"] for r in got.gossip_summary()["rings"][0]] == [1]


# ---------------------------------------------------------------------------
# Warmth on a live port engine's summary
# ---------------------------------------------------------------------------

SERVED = {"task": "txt2img", "prompt": "a warm cat", "seed": 3, "timesteps": MAX_STEPS}


@pytest.fixture(scope="module")
def live_summary():
    """(routing, slots summary, key delta since 0) of a port engine at
    sd_toy (``cross``) that served ``SERVED`` in process."""
    cfg = EngineConfig(**ENGINE)
    bundle = CFG.build_engine(cfg)
    factory = RequestFactory(bundle.ucfg, bundle.dcfg, cfg, policy=bundle.policy)
    (req,), _, _ = factory.build(SERVED)
    done, _ = bundle.engine.run([req])
    assert [d.rid for d in done] == [req.rid]
    cache = bundle.engine.cache
    return HTTPFrontend(None, factory)._routing_info(), cache.slots_summary(), cache.keys_delta(0)


@pytest.mark.parametrize("payload,warm", [
    (SERVED, True),
    (dict(SERVED, prompt="another prompt"), False),
    (dict(SERVED, seed=4), False),
    (dict(SERVED, task="img2img", init={"seed": 1}, strength=0.5), False),
])
def test_warmth_on_a_live_summary_equals_reference(live_summary, payload, warm):
    routing, summary, delta = live_summary
    assert summary["mode"] == "cross" and summary["rings"][0]
    got, ref = _both("payload_warmth", payload, routing, summary)
    assert got == ref
    assert (got > 0.0) == warm
    # the same rows gossiped through /cache/keys score the same
    h = _fake_keys_handle(R.ReplicaHandle, [delta])
    asyncio.run(h.refresh_keys())
    assert R.payload_warmth(payload, routing, h.gossip_summary()) == got


# ---------------------------------------------------------------------------
# The gateway process
# ---------------------------------------------------------------------------


def test_router_process_imports_no_torch():
    """The gateway supervises engine subprocesses; importing it never pays
    (or requires) the torch import, nor JAX, nor the reference package."""
    code = (
        "import sys\n"
        "import repro_torch.launch.router, repro_torch.serving.router\n"
        "import repro_torch.runtime.fault_tolerance\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=WAIT_S)
    assert out.returncode == 0, out.stderr


def test_replica_command_forwards_the_engine_flags():
    args = LR.build_parser().parse_args([*FLEET, "--seed", "7", "--quality", "draft"])
    cmd = LR.replica_command(args)
    # every forwarded flag parses as the replica's own CLI would read it
    got = SERVE.build_parser().parse_args(cmd[3:])
    want = SERVE.build_parser().parse_args([*FLEET, "--seed", "7", "--quality", "draft",
                                            "--http", "127.0.0.1:0"])
    assert vars(got) == vars(want)
    assert "--kernels" not in cmd
    gpu = LR.replica_command(LR.build_parser().parse_args(["--kernels", "cuda"]))
    assert gpu[gpu.index("--device") + 1] == gpu[gpu.index("--kernels") + 1] == "cuda"


def test_router_without_a_gpu_exits_and_binds_nothing(tmp_path):
    """No ``--device cpu``: the replica refuses the missing GPU, and the
    router names its failure and exits non-zero; it never retries on the
    CPU and never publishes a port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the replica would start on it")
    port_file = tmp_path / "router.port"
    router = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.router", "--replicas", "1",
         "--port-file", str(port_file), "--run-dir", str(tmp_path)],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, err = router.communicate(timeout=WAIT_S)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(router.pid, signal.SIGKILL)  # a replica that did start dies too
        router.communicate()
    assert router.returncode != 0
    assert not port_file.exists()
    assert "replica 0 exited" in err and "none is available" in err
    assert "spawning 1 replicas on cuda" in out


# ---------------------------------------------------------------------------
# The fleet on the CPU
# ---------------------------------------------------------------------------

KILL = {"task": "txt2img", "prompt": "kill me", "seed": 5, "timesteps": 4}


def _reference_digest() -> str:
    """``KILL``'s digest from an in-process engine built with
    ``CFG.from_args`` from the fleet's flags, serving it first."""
    cfg = CFG.from_args(SERVE.build_parser().parse_args(FLEET), decode_images=False)
    bundle = CFG.build_engine(cfg)
    factory = RequestFactory(bundle.ucfg, bundle.dcfg, cfg, policy=bundle.policy,
                             default_quality=cfg.quality)
    (req,), _, _ = factory.build(KILL)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        done, _ = bundle.engine.run([req])
    finally:
        torch.set_num_threads(prev)
    return latent_digest(done[0].latent)


async def _fleet(port: int, port_file: str) -> dict:
    c = FrontendClient("127.0.0.1", port)
    await c.wait_ready(WAIT_S)
    stats = await c.stats()
    assert stats["router"]["ready"] == 2
    pids = {e["idx"]: e["pid"] for e in stats["replicas"]}

    # 1. one request alone; its replica is killed after its second step
    events, victim, killed = [], None, False
    async for ev in c.generate_stream(**KILL):
        events.append(ev)
        if ev["event"] == "queued" and victim is None:
            victim = ev["replica"]
        if ev["event"] == "step" and ev["step"] == 2 and not killed:
            os.kill(pids[victim], signal.SIGKILL)
            killed = True
    kinds = [e["event"] for e in events]
    assert kinds[-1] == "done" and kinds.count("requeued") == 1, kinds
    after = kinds[kinds.index("requeued") + 1:]
    steps = [e["step"] for e in events[kinds.index("requeued"):] if e["event"] == "step"]
    assert after[0] == "queued" and steps == [1, 2, 3, 4], kinds
    digest = events[-1]["latent_digest"]

    # 3. the same payload, cache off: the same (cold) digest
    again = await c.generate(**dict(KILL, allow_cache=False))
    assert again["event"] == "done"

    # 4. the supervisor brings the victim back as a fresh generation
    deadline = time.perf_counter() + WAIT_S
    while (s := await c.stats())["router"]["ready"] != 2 and time.perf_counter() < deadline:
        await asyncio.sleep(0.5)

    # 5. the client CLI with its --router checks, against the healed fleet
    cli = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "repro_torch.serving.client", "--port-file", port_file,
        "--requests", "4", "--concurrency", "2", "--t-lo", "2", "--t-hi", "4",
        "--task", "mix", "--router", env=_env(), cwd=REPO,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
    )
    cli_out, cli_err = await asyncio.wait_for(cli.communicate(), WAIT_S)
    final = await c.stats()
    await c.shutdown()  # 6. the rolling drain
    return dict(digest=digest, again=again["latent_digest"], healed=s, victim=victim,
                cli=(cli.returncode, cli_out.decode(), cli_err.decode()), final=final)


def test_fleet_fails_over_respawns_and_drains(tmp_path):
    port_file = str(tmp_path / "router.port")
    router = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.router", "--replicas", "2", *FLEET,
         "--http", "127.0.0.1:0", "--port-file", port_file, "--run-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=REPO,
        start_new_session=True,  # one process group: the router and its replicas
    )
    try:
        deadline = time.perf_counter() + WAIT_S
        while not os.path.exists(port_file):
            assert router.poll() is None, router.communicate()[0][-3000:]
            assert time.perf_counter() < deadline, "the router never published its port"
            time.sleep(0.2)
        with open(port_file) as f:
            port = int(f.read())
        want = _reference_digest()
        out = asyncio.run(asyncio.wait_for(_fleet(port, port_file), 4 * WAIT_S))
        log, _ = router.communicate(timeout=WAIT_S)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(router.pid, signal.SIGKILL)  # no replica outlives a failed test
        router.communicate()

    # 2. the failed-over digest is the in-process engine's; so is the replay
    assert out["digest"] == want and out["again"] == want
    healed = out["healed"]["router"]
    assert healed["ready"] == 2, out["healed"]
    assert healed["evictions"] >= 1 and healed["respawns"] >= 1
    assert healed["resubmitted"] >= 1 and healed["failed"] == 0
    gens = {e["idx"]: e["generation"] for e in out["healed"]["replicas"]}
    assert gens[out["victim"]] >= 2, gens
    # bench_router.py's kill gates: the accepted request completed, the
    # killed replica came back
    kill_completion_ratio = healed["completed"] / healed["accepted"]
    kill_respawn = float(healed["ready"] == 2 and healed["respawns"] >= 1)
    assert (kill_completion_ratio, kill_respawn) == (1.0, 1.0)
    rc, cli_out, cli_err = out["cli"]
    assert rc == 0, cli_err[-2000:] + cli_out[-2000:]
    assert "[client] router:" in cli_out and "[client] replica:" in cli_out
    assert out["final"]["router"]["failed"] == 0
    assert router.returncode == 0, log[-3000:]
    assert "'drained': True" in log
