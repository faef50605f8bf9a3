"""The port's own ranges (``repro_torch.common.trace``) on the CPU.

At ``sd_toy`` with the ``eager`` backend: off, no range costs anything but
its flag test; on (a CPU ``torch.profiler``), every name is one the
benchmark's trace reduction can file, the engine's and the driver's phases
come in order, the work ranges' counts are ``bench/flops.py``'s, and their
operations over one CFG pass of each class add up to the reference's
(also at ``sd_v14``, on meta tensors).  Tracing changes no output bit, and
``ServingMetrics.step_wait_s`` counts the engine's waits on the device.
"""
from __future__ import annotations

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import flops  # noqa: E402  (the benchmark's counting rules)
from repro_torch.common import trace as T  # noqa: E402
from repro_torch.configs import get_unet_config  # noqa: E402
from repro_torch.core import sampler as SM  # noqa: E402
from repro_torch.models import backend as B  # noqa: E402
from repro_torch.models import unet as U  # noqa: E402
from repro_torch.serving import config as CFG  # noqa: E402
from repro_torch.serving import lanes as LN  # noqa: E402
from repro_torch.serving.driver import EngineDriver  # noqa: E402
from repro_torch.serving.engine import EngineConfig, GenRequest  # noqa: E402
from repro_torch.serving.metrics import ServingMetrics  # noqa: E402

TOY = get_unet_config("sd_toy")
#: a work range carries two integers, a phase range none
NAME = re.compile(r"repro\.(?:[a-z_]+\|\d+\|\d+|(?:engine|driver)\.[a-z]+)")
PHASES = ("driver.inbox", "engine.backfill", "engine.vote", "engine.upload", "engine.dispatch",
          "engine.retire", "driver.events")
WORK = ("uniconv", "attention_core", "linear")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bundle(n_shards: int = 1):
    return CFG.build_engine(EngineConfig(n_lanes=2, max_steps=8, device="cpu",
                                         decode_images=True, n_shards=n_shards))


@pytest.fixture(scope="module")
def bundle():
    return _bundle()


def _requests(bundle, n: int = 3) -> list[GenRequest]:
    """Balanced 6-step requests: their plans run FULL, SKETCH and REFINE."""
    pol = bundle.policy.resolve(6, quality="balanced")
    rng = np.random.default_rng(27)
    u = bundle.ucfg
    return [
        GenRequest(rid=i, ctx=rng.normal(size=(u.ctx_len, u.ctx_dim)).astype(np.float32),
                   noise=rng.normal(size=(u.latent_size**2, u.in_channels)).astype(np.float32),
                   timesteps=6, plan=pol.plan, policy=pol)
        for i in range(n)
    ]


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof) -> list[tuple[int, int, str]]:
    """(start, end, name) of every ``repro.`` range, in start order."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("repro."))


def _ints(name: str) -> tuple[int, int]:
    _, ops, nbytes = name.split("|")
    return int(ops), int(nbytes)


def _kind(name: str) -> str:
    return name.split("|")[0][len("repro."):]


def test_off_costs_nothing(monkeypatch, bundle):
    calls = []
    monkeypatch.setattr(T, "record_function", lambda *a: calls.append(a))
    for name in ("conv_cost", "dense_cost", "attention_core_cost", "group_norm_cost"):
        monkeypatch.setattr(T, name, lambda *a, _n=name: calls.append(_n))
    monkeypatch.setattr(LN, "_lanes", lambda *a: calls.append("lanes"))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert T.work("linear", T.dense_cost) is T.phase("engine.vote")  # the shared null context
    done, summary = bundle.engine.run(_requests(bundle))
    assert len(done) == 3 and summary["sketch_steps"] and summary["refine_steps"]
    assert calls == []


@pytest.mark.parametrize("n_shards", [1, 2])
def test_names_and_phase_order(n_shards):
    """One driver run over three requests: every name is well formed, each
    iteration's phases come in order, and each micro-step's range lies in
    its dispatch."""
    b = _bundle(n_shards)
    drv = EngineDriver(b.engine)
    for r in _requests(b):
        drv.submit(r)
    with drv._lock:
        drv._stopping = True  # the loop ends once the stream has drained
    with _profile() as prof:
        drv._run()
    ranges = _ranges(prof)
    for _, _, name in ranges:
        assert NAME.fullmatch(name), name
    letters = "".join("IBVUDRE"[PHASES.index(n[6:])] for _, _, n in ranges if "|" not in n)
    step = "BVUDR" if n_shards == 1 else "BVDR"
    assert re.fullmatch(f"(I{step}E)+I+", letters), letters
    dispatch = [(s, e) for s, e, n in ranges if n == "repro.engine.dispatch"]
    steps = [(s, e, n) for s, e, n in ranges if n.startswith("repro.step_")]
    assert {_kind(n) for _, _, n in steps} == {"step_full", "step_sketch", "step_refine"}
    for s, e, n in steps:
        assert any(ds <= s and e <= de for ds, de in dispatch), n
        assert 1 <= _ints(n)[0] <= _ints(n)[1] == 2 // n_shards
    assert drv._final_summary["completed"] == 3 and drv._final_summary["step_wait_s"] > 0


def test_micro_step_counts_its_lanes():
    """Without ``n_advanced`` the range counts ``sel`` on the device."""
    ucfg, dcfg, params, _ = CFG.init_models(EngineConfig(device="cpu", decode_images=False))
    n_up = U.n_up_steps(ucfg)
    step = LN.make_micro_step(ucfg, dcfg, params, n_up - 3, n_up - 2, device="cpu")
    state = LN.init_lanes(ucfg, 2, 4, n_up - 3, n_up - 2, "cpu")
    plan = LN.make_plan_arrays(dcfg, 4, None, 4)
    LN.admit(state, 0, torch.zeros(ucfg.latent_size**2, ucfg.in_channels),
             torch.zeros(ucfg.ctx_len, ucfg.ctx_dim), plan)
    with _profile() as prof:
        step(state, SM.FULL, torch.tensor([True, False]))
        step(state, SM.FULL, torch.tensor([True, False]), n_advanced=1)
    names = [n for _, _, n in _ranges(prof) if n.startswith("repro.step_")]
    assert names == ["repro.step_full|1|2"] * 2


def test_call_counts_are_the_benchmarks(monkeypatch):
    """Each ``uniconv`` range carries ``bench/flops.py``'s ``conv_cost`` of
    its call; an ``attention_core`` range and its out-projection's
    ``linear`` range carry ``attention_cost``'s operations, and its bytes
    plus the core's output, written by one and read by the other."""
    convs, attns = [], []
    conv, core = B.uniconv_apply, B.mha_core

    def log_conv(w, b, x, hw, ksize, stride=1):
        convs.append((x.shape, w.shape, hw, ksize, stride))
        return conv(w, b, x, hw, ksize, stride)

    def log_core(q, k, v, n_heads):
        attns.append((q.shape, k.shape, n_heads))
        return core(q, k, v, n_heads)

    monkeypatch.setattr(B, "uniconv_apply", log_conv)
    monkeypatch.setattr(B, "mha_core", log_core)
    ucfg, _, params, _ = CFG.init_models(EngineConfig(device="cpu", decode_images=False))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, ucfg.latent_size**2, ucfg.in_channels, generator=gen)
    ctx2 = torch.randn(2, ucfg.ctx_len, ucfg.ctx_dim, generator=gen)
    with _profile() as prof:
        SM.cfg_unet_step(ucfg, params, 7.5, x, torch.tensor([981]), ctx2)
    names = [n for _, _, n in _ranges(prof)]
    assert [_ints(n) for n in names if _kind(n) == "uniconv"] == [
        flops.conv_cost(*c) for c in convs]
    at = [i for i, n in enumerate(names) if _kind(n) == "attention_core"]
    assert len(at) == len(attns) > 0
    for i, (q_shape, k_shape, n_heads) in zip(at, attns):
        assert _kind(names[i + 1]) == "linear"
        (c_ops, c_bytes), (p_ops, p_bytes) = _ints(names[i]), _ints(names[i + 1])
        ops, nbytes = flops.attention_cost(q_shape, k_shape, n_heads)
        assert c_ops + p_ops == ops
        assert c_bytes + p_bytes == nbytes + 2 * flops.F32 * q_shape.numel()


@pytest.mark.parametrize("name", ["sd_toy", "sd_v14"])
def test_class_operations_are_the_references(name):
    """The operations of the ``uniconv``, ``attention_core`` and ``linear``
    ranges of one CFG pass (batch 2) of each class equal
    ``bench/flops.py::class_flops``, the reference's own count (on meta
    tensors: shapes only)."""
    ucfg = get_unet_config(name)
    cfg = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(ucfg).items() if k != "name"}
    want = flops.class_flops(cfg, 3, 2)
    params = U.init_unet(ucfg, U._Shapes())
    n_up = U.n_up_steps(ucfg)
    meta = dict(device="meta")
    x = torch.empty(1, ucfg.latent_size**2, ucfg.in_channels, **meta)
    ctx2 = torch.empty(2, ucfg.ctx_len, ucfg.ctx_dim, **meta)
    for cls, entry in (("FULL", 0), ("SKETCH", n_up - 3), ("REFINE", n_up - 2)):
        feat = torch.empty(SM.feat_shape(ucfg, entry, 2), **meta) if entry else None
        with _profile() as prof:
            SM.cfg_unet_step(ucfg, params, 7.5, x, torch.tensor([981], **meta), ctx2,
                             entry_step=entry, entry_feat=feat)
        got = sum(_ints(n)[0] for _, _, n in _ranges(prof) if _kind(n) in WORK)
        assert got == want[cls], (cls, got, want[cls])


def test_ranges_yield_to_a_wrapping_backend():
    """Under a backend built over another's functions, the inner call's
    ``uniconv`` and out-projection ranges stay shut (the wrapper's own
    ranges keep their device twins); the group norm and core ranges open."""
    eager = B.EAGER
    wrapped = B.KernelBackend(
        "wrapped", lambda *a, **k: eager.conv(*a, **k),
        lambda *a, **k: eager.group_norm(*a, **k), lambda *a, **k: eager.attention(*a, **k))
    x = torch.randn(2, 16, 8)
    p = {"scale": torch.ones(8), "bias": torch.zeros(8)}
    for bk, want in ((eager, {"uniconv", "stream_group_norm", "attention_core", "linear"}),
                     (wrapped, {"stream_group_norm", "attention_core"})):
        with _profile() as prof:
            bk.conv(torch.randn(9, 8, 8), torch.zeros(8), x, (4, 4), 3)
            bk.group_norm(x, p, 4, silu=True)
            bk.attention(x, x, x, torch.randn(8, 8), 2)
        assert {_kind(n) for _, _, n in _ranges(prof)} == want


def test_outputs_bitwise_equal_with_profiler_on():
    off = _bundle().engine.run(_requests(_bundle()))[0]
    b = _bundle()
    with _profile():
        on = b.engine.run(_requests(b))[0]
    for a, c in zip(sorted(off, key=lambda d: d.rid), sorted(on, key=lambda d: d.rid)):
        assert a.rid == c.rid
        assert np.array_equal(a.latent, c.latent) and np.array_equal(a.image, c.image)


def test_step_wait_counts_uploads_and_retirements(monkeypatch, bundle):
    waits = []
    record = ServingMetrics.record_wait
    monkeypatch.setattr(ServingMetrics, "record_wait",
                        lambda self, s: waits.append(s) or record(self, s))
    done, summary = bundle.engine.run(_requests(bundle))
    assert len(waits) == summary["micro_steps"] + len(done)
    assert summary["step_wait_s"] == round(sum(waits), 6)
    wall = sum(t for _, t in bundle.engine.metrics.step_time_by_backend.values())
    assert 0 < sum(waits) < wall
