"""The readers of the program's own ranges (``repro_torch.common.trace``).

On the CPU: ``linear_roofline``, ``attention_core_roofline``,
``group_norm_roofline``, ``sketch_step_ms`` and ``refine_step_ms`` on a
synthetic record, and None where their kind is absent.  On the card
(``cuda``): micro-steps of each class, traced, through the unchanged
``bench.trace.summarize``, whose ``calls`` hold every program kind with as
many calls as ranges were entered; with ``bench.trace.install``'s wrappers
too, where the ``uniconv`` ranges yield to the wrapper's ``conv`` ranges.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import pytest

from bench import spec
from bench.flops import PEAK_BYTES_S, PEAK_FLOPS
from bench.tests.conftest import ROOT

#: kind -> [[operations, bytes, calls, device seconds], ...], as summarize files them
CALLS = {
    "linear": [[4_000_000_000, 96_000_000, 10, 0.004], [1_000_000_000, 40_000_000, 2, 0.001]],
    "attention_core": [[8_000_000_000, 64_000_000, 4, 0.002]],
    "stream_group_norm": [[0, 335_000_000, 3, 0.0005]],
    "step_sketch": [[3, 8, 2, 0.26], [8, 8, 1, 0.1301]],
    "step_refine": [[4, 8, 4, 0.308]],
}


def _share(rows):
    least = sum(n * max(ops / PEAK_FLOPS, nb / PEAK_BYTES_S) for ops, nb, n, _ in rows)
    return 100.0 * least / sum(s for *_, s in rows)


@pytest.mark.parametrize("metric, kind, want", [
    ("linear_roofline", "linear", _share(CALLS["linear"])),
    ("attention_core_roofline", "attention_core", _share(CALLS["attention_core"])),
    ("group_norm_roofline", "stream_group_norm", 100.0 * 3 * 335_000_000 / PEAK_BYTES_S / 0.0005),
    ("sketch_step_ms", "step_sketch", 1e3 * 0.3901 / 3),
    ("refine_step_ms", "step_refine", 1e3 * 0.308 / 4),
])
def test_reader_values(metric, kind, want):
    read = spec.reader(metric)
    assert read({"trace": {"calls": CALLS}}) == pytest.approx(want, rel=1e-12)
    assert read({"trace": None}) is None
    assert read({"trace": {"calls": {}}}) is None
    assert read({"trace": {"calls": {k: v for k, v in CALLS.items() if k != kind}}}) is None


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device ranges exist only under CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("wrapped", [False, True])
def test_program_ranges_reach_the_trace(card, monkeypatch, wrapped):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench import serve
    from bench import trace as BT
    from bench.run import fixed_caches
    from repro_torch.common import trace as T

    fixed_caches(ROOT)
    P = serve.program_modules()
    if wrapped:  # restored after the test
        monkeypatch.setattr(P.backend, "CUDA", P.backend.CUDA)
        monkeypatch.setattr(P.lanes, "make_micro_step", P.lanes.make_micro_step)
        BT.install(P)
    bundle = P.config.build_engine(P.engine.EngineConfig(
        n_lanes=2, max_steps=8, device="cuda", backend="cuda", unet="sd_v14", decode_images=True))
    engine, u = bundle.engine, bundle.ucfg
    pol = bundle.policy.resolve(6, quality="balanced")
    rng = np.random.default_rng(27)

    def requests(base):
        return [P.engine.GenRequest(
            rid=base + i, ctx=rng.normal(size=(u.ctx_len, u.ctx_dim)).astype(np.float32) * 0.2,
            noise=rng.normal(size=(u.latent_size**2, u.in_channels)).astype(np.float32),
            timesteps=6, plan=pol.plan, policy=pol) for i in range(2)]

    engine.run(requests(0))  # builds the kernels and prepares the weights
    entered = collections.Counter()
    record_function = T.record_function

    def counted(name):
        entered[name.split("|")[0][len("repro."):]] += "|" in name
        return record_function(name)

    monkeypatch.setattr(T, "record_function", counted)
    for r in requests(10):
        engine.submit(r)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.time_ns()
    while engine.n_active or engine.n_pending:
        engine.step()
    torch.cuda.synchronize()
    t1 = time.time_ns()
    prof.stop()
    calls = BT.summarize(prof.profiler.kineto_results, t0, t1)["calls"]
    kinds = {"attention_core", "linear", "stream_group_norm", "step_full", "step_sketch",
             "step_refine"} | ({"conv", "attention"} if wrapped else {"uniconv"})
    assert set(calls) == kinds, sorted(calls)
    for kind in kinds - {"conv", "attention"}:
        assert sum(row[2] for row in calls[kind]) == entered[kind] > 0, kind
    print({k: sum(row[2] for row in v) for k, v in sorted(calls.items())})
