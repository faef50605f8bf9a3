"""The port's cached, policy-driven engine against the JAX package's engine.

Three sd_toy streams run through ``repro.serving.DiffusionEngine`` and the
port's ``DiffusionEngine`` on the same bridged weights:

* (a) ``spill``: donor, two cold churners, twin on 1 lane; ``cross`` at
  threshold 0.2 with 2 slots, one bucket and a 16 MiB spill ring, so the
  donor's capture is evicted to the host and promoted back for the twin
  (the stream of ``test_serving_cache.py::test_engine_spill_prefetch_promotes_and_serves``);
* (b) ``intra``: an identical twin pair in ``intra`` mode, each lane
  skipping its own later FULL refreshes;
* (c) ``draft``: ``draft``-tier requests (SKETCH->REFINE demotions) beside
  ``balanced`` and ``exact`` ones on one prompt, 2 lanes.

Latents agree within 5e-4, the engine tolerance of the JAX package's own
differential tests (measured: 6.1e-5, 6.0e-5 and 7.1e-5 on latents of up
to 26.4, as for the uncached engine); every cache and demotion counter is
*equal*.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.common.types import PASPlan as JPlan
from repro.configs import get_unet_config
from repro.models import unet as JU
from repro.serving import DiffusionEngine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import GenRequest as JRequest
from repro.serving import policy as JP
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.core import sampler as SM
from repro_torch.serving import lanes as LN
from repro_torch.serving import policy as TP
from repro_torch.serving.cache import CacheState
from repro_torch.serving.engine import DiffusionEngine, EngineConfig, GenRequest

TOY = get_unet_config("sd_toy")
N_UP = JU.n_up_steps(TOY)
L = TOY.latent_size**2
TOL = 5e-4
#: counters that must be equal between the two engines
COUNTERS = (
    "full_steps", "sketch_steps", "refine_steps", "demoted_full_steps",
    "demoted_sketch_steps", "cache_hit_rate", "hbm_hits", "spill_promotions",
    "cache_probes", "cache_probe_hits", "cache_inserts", "cache_evictions",
    "cache_warm_slots", "micro_steps", "lane_steps_advanced", "quality_mix",
)
SPILL_COUNTERS = ("cache_spill_demotions", "cache_spill_promotions", "cache_spill_entries",
                  "cache_spill_bytes", "cache_spill_evictions")
BASE = dict(max_steps=8, l_sketch=3, l_refine=2, decode_images=False)
STREAMS = {
    "spill": dict(n_lanes=1, cache_mode="cross", cache_threshold=0.2, cache_slots=2,
                  cache_t_bucket=1000, cache_spill_mb=16),
    "intra": dict(n_lanes=1, cache_mode="intra", cache_threshold=0.2, cache_t_bucket=1000),
    "draft": dict(n_lanes=2, cache_mode="cross", cache_slots=4, cache_t_bucket=1000),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jparams = jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(0), TOY)
    return jparams, bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _plan(t, pkg_plan):
    return pkg_plan(t_sketch=max(2, t // 2 + 1), t_complete=2, t_sparse=2, l_sketch=3, l_refine=2)


def _stream(name: str, jax_side: bool) -> list:
    """The named stream, built with one package's request/plan/policy types."""
    Req, Plan = (JRequest, JPlan) if jax_side else (GenRequest, PASPlan)
    twin = np.random.default_rng(77).normal(size=(TOY.ctx_len, TOY.ctx_dim)).astype(np.float32)

    def req(rid, t, noise_seed=None, ctx=None, plan=True, quality=None):
        rng = np.random.default_rng(300 + (rid if noise_seed is None else noise_seed))
        c = rng.normal(size=(TOY.ctx_len, TOY.ctx_dim)).astype(np.float32) if ctx is None else ctx
        pol = None
        if quality is not None:
            pol = (JP if jax_side else TP).QualityPolicy(N_UP).resolve(t, quality=quality)
        return Req(
            rid=rid, ctx=c * 0.2, noise=rng.normal(size=(L, TOY.in_channels)).astype(np.float32),
            timesteps=t, plan=pol.plan if pol is not None else (_plan(t, Plan) if plan else None),
            policy=pol,
        )

    if name == "spill":
        return [req(0, 6, 0, twin), req(1, 6), req(2, 6), req(3, 6, 0, twin)]
    if name == "intra":
        return [req(0, 6, 0, twin), req(1, 6, 0, twin)]
    return [req(0, 6, 0, twin, quality="draft"), req(1, 6, 1, twin, quality="balanced"),
            req(2, 6, 2, twin, quality="draft"), req(3, 6, 3, twin, quality="exact"),
            req(4, 7, 4, twin * 1.05, quality="draft")]


_JAX_RUNS: dict = {}


def _jax_run(name, jparams):
    """Each JAX stream runs (and compiles) once per module."""
    if name not in _JAX_RUNS:
        eng = JEngine(TOY, JDiffusionConfig(timesteps_sample=6), jparams, None,
                      JConfig(**BASE, **STREAMS[name]))
        done, summary = eng.run(_stream(name, jax_side=True))
        _JAX_RUNS[name] = ({d.rid: d.latent for d in done}, summary)
    return _JAX_RUNS[name]


_PORT_RUNS: dict = {}


def _port_run(name, tparams):
    """Each port stream runs once per module, as its JAX twin does."""
    if name not in _PORT_RUNS:
        cfg = EngineConfig(device="cpu", **BASE, **STREAMS[name])
        eng = DiffusionEngine(TOY, DiffusionConfig(timesteps_sample=6), tparams, None, cfg)
        done, summary = eng.run(_stream(name, jax_side=False))
        _PORT_RUNS[name] = ({d.rid: d.latent for d in done}, summary)
    return _PORT_RUNS[name]


@pytest.mark.parametrize("name", list(STREAMS))
def test_cached_engine_latents_match_jax(weights, name):
    ref, _ = _jax_run(name, weights[0])
    got, _ = _port_run(name, weights[1])
    assert sorted(got) == sorted(ref)
    for rid in ref:
        np.testing.assert_allclose(got[rid], ref[rid], atol=TOL, rtol=0, err_msg=f"rid={rid}")


@pytest.mark.parametrize("name", list(STREAMS))
def test_cached_engine_counters_equal_jax(weights, name):
    _, ref = _jax_run(name, weights[0])
    _, got = _port_run(name, weights[1])
    keys = COUNTERS + (SPILL_COUNTERS if "cache_spill_demotions" in ref else ())
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}
    # each stream exercises the path it is here for
    if name == "spill":
        assert got["spill_promotions"] > 0 and got["cache_spill_demotions"] > 0
        assert got["demoted_full_steps"] > 0
    elif name == "intra":
        assert got["demoted_full_steps"] > 0
    else:
        assert got["demoted_sketch_steps"] > 0 and got["demoted_full_steps"] > 0


@pytest.mark.parametrize("name", ["spill", "draft"])
def test_threshold_zero_is_bitwise_cache_off(weights, name):
    """A ``cross`` engine at threshold 0, spill on, serves latents bitwise
    equal to the cache-off engine (the draft stream's policies resolve their
    own thresholds, so it runs at ``exact`` there: every request threshold 0)."""
    def exact():
        reqs = _stream(name, jax_side=False)
        for r in reqs:
            if r.policy is not None:
                r.policy = TP.QualityPolicy(N_UP).resolve(r.timesteps, quality="exact")
                r.plan = None
        return reqs

    def run(**over):
        cfg = EngineConfig(device="cpu", **BASE, **dict(STREAMS[name], **over))
        eng = DiffusionEngine(TOY, DiffusionConfig(timesteps_sample=6), weights[1], None, cfg)
        done, summary = eng.run(exact())
        return {d.rid: d.latent for d in done}, summary

    off, _ = run(cache_mode="off")
    got, summary = run(cache_threshold=0.0, cache_spill_mb=16)
    assert summary["demoted_full_steps"] == summary["demoted_sketch_steps"] == 0
    assert summary["spill_promotions"] == 0 and summary["cache_inserts"] > 0
    for rid in off:
        assert torch.equal(torch.from_numpy(got[rid]), torch.from_numpy(off[rid])), rid


def _lanes_with_warm_slot(weights):
    """Two lanes after one FULL micro-step, and a cache whose slot 0 holds
    other features than either lane's."""
    dcfg = DiffusionConfig(timesteps_sample=6)
    e_sk, e_rf = N_UP - 3, N_UP - 2
    state = LN.init_lanes(TOY, 2, 8, e_sk, e_rf, "cpu")
    rng = np.random.default_rng(0)
    for lane in range(2):
        plan = LN.make_plan_arrays(dcfg, 6, _plan(6, PASPlan), 8, threshold=0.0 if lane else 0.3)
        LN.admit(state, lane,
                 torch.from_numpy(rng.normal(size=(L, 4)).astype(np.float32)),
                 torch.from_numpy(rng.normal(size=(TOY.ctx_len, TOY.ctx_dim)).astype(np.float32)),
                 plan)
    micro = LN.make_micro_step(TOY, dcfg, weights[1], e_sk, e_rf, device="cpu")
    micro(state, SM.FULL, torch.tensor([True, True]))
    cache = CacheState(
        f_sk=torch.randn((2, 2) + tuple(state.f_sk.shape[1:])),
        f_rf=torch.randn((2, 2) + tuple(state.f_rf.shape[1:])),
    )
    return state, micro, cache


@pytest.mark.parametrize("branch", [SM.SKETCH, SM.REFINE], ids=["sketch", "refine"])
def test_micro_step_gates_on_the_lane_threshold_and_adopts_on_sketch(weights, branch):
    """Lane 0 (threshold 0.3) consumes slot 0 at distance 0.1; lane 1
    (threshold 0) is handed the same slot at distance 0 and must not use it.
    SKETCH adopts the slot as lane 0's features; REFINE keeps its own."""
    state, micro, cache = _lanes_with_warm_slot(weights)
    own = (state.f_sk.clone(), state.f_rf.clone())
    ref_state, _, _ = _lanes_with_warm_slot(weights)
    sel = torch.tensor([True, True])
    micro(state, branch, sel, torch.tensor([0, 0]), torch.tensor([0.1, 0.0]), cache)
    micro(ref_state, branch, sel)  # uncached: both lanes on their own features
    assert not torch.equal(state.x[0], ref_state.x[0])  # lane 0 used the slot
    assert torch.equal(state.x[1], ref_state.x[1])  # lane 1 did not
    for f, own_f, slot in ((state.f_sk, own[0], cache.f_sk), (state.f_rf, own[1], cache.f_rf)):
        assert torch.equal(f[1], own_f[1]) and torch.equal(f[3], own_f[3])
        if branch == SM.SKETCH:
            assert torch.equal(f[0], slot[0, 0]) and torch.equal(f[2], slot[0, 1])
        else:
            assert torch.equal(f[0], own_f[0]) and torch.equal(f[2], own_f[2])


def test_micro_step_at_distance_equal_to_threshold_does_not_hit(weights):
    state, micro, cache = _lanes_with_warm_slot(weights)
    ref_state, _, _ = _lanes_with_warm_slot(weights)
    thr = float(state.thr[0, 1])  # the lane's float32 threshold at step 1
    micro(state, SM.SKETCH, torch.tensor([True, False]), torch.tensor([0, -1]),
          torch.tensor([thr, float("inf")]), cache)
    micro(ref_state, SM.SKETCH, torch.tensor([True, False]))
    assert torch.equal(state.x, ref_state.x) and torch.equal(state.f_sk, ref_state.f_sk)


def test_engine_progress_and_cancel(weights):
    cfg = EngineConfig(device="cpu", **BASE, **STREAMS["draft"])
    eng = DiffusionEngine(TOY, DiffusionConfig(timesteps_sample=6), weights[1], None, cfg)
    reqs = _stream("draft", jax_side=False)
    for r in reqs:
        eng.submit(r)
    eng.step()
    prog = eng.progress()
    assert [p[1] for p in prog] == [1, 1] and {p[0] for p in prog} == {0, 1}
    assert eng.cancel(3) and not eng.cancel(3)  # queued: leaves the queue
    assert eng.cancel(0) and eng.n_active == 1  # in flight: lane released
    assert not eng.cancel(42)
    done = []
    while eng.n_pending or eng.n_active:
        done.extend(eng.step())
    assert sorted(d.rid for d in done) == [1, 2, 4]
    assert eng.metrics.quality_mix == {"balanced": 1, "draft": 3, "exact": 1}


def test_chip_smoke_phase6_stream_counters_on_the_cpu():
    """``chip_smoke.py`` phase 6's stream at sd_toy on the CPU: the cache's
    decisions are host-only, so these are the counters the card must show
    at sd_v14 (the phase requires each kind of reuse to occur)."""
    import importlib.util
    import math
    import pathlib

    from repro_torch.models import unet as TU
    from repro_torch.serving import config as CFG
    from repro_torch.serving.policy import default_pas_plan

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    config = EngineConfig(n_lanes=cs.N_LANES, max_steps=cs.MAX_STEPS, l_sketch=3, l_refine=2,
                          decode_images=False, device="cpu", unet="sd_toy")
    models = CFG.init_models(config)
    ucfg, dcfg = models[0], models[1]
    n_up = TU.n_up_steps(ucfg)
    slot_bytes = 8 * sum(math.prod(SM.feat_shape(ucfg, e, 1)) for e in (n_up - 3, n_up - 2))
    cached = dataclasses.replace(
        config, cache_spill_mb=cs.P6_SPILL_SLOTS * slot_bytes / 2**20 * 1.001, **cs.P6_CACHE)
    policy = CFG.build_policy(cached, ucfg, dcfg)
    summaries = []
    for cfg in (cached, config):
        reqs = [r for _, r in cs.phase6_stream(np, ucfg, n_up, policy, GenRequest, default_pas_plan)]
        summaries.append(CFG.build_engine(cfg, models=models).engine.run(reqs)[1])
    got, off = summaries
    assert (got["full_steps"], off["full_steps"]) == (28, 30)
    assert (got["demoted_full_steps"], got["demoted_sketch_steps"]) == (2, 1)
    assert (got["cache_spill_demotions"], got["spill_promotions"]) == (26, 1)
    assert got["quality_mix"] == {"draft": 1, "exact": 1, "full": 1, "pas": 9}
