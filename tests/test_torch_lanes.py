"""The micro-step on the advancing lanes alone (``serving/lanes.py``).

Where the host hands the micro-step the indices of the lanes the vote
advances and they are fewer than the lanes, the U-Net, PNDM and the
inpaint blend run on those lanes only and their state is written back in
place.  On the CPU (``sd_toy``, ``eager``), for each branch class and an
advance mask of all, some and one lane:

* the advanced lanes match the masked full-batch step within the engine's
  tolerance, and every lane outside the mask keeps every bit;
* with every lane advancing the step is the masked step, bitwise, and
  gathers nothing;
* the same with cache arguments (some lanes consume a slot) and on the
  sharded micro-step (shard-local indices);
* both engines serve a stream as they do with the masked step, counters
  equal and ``lane_steps_computed`` the lanes advanced.

On the card (``cuda``, ``sd_v14``): each class at 3 of 8 lanes against the
full-batch masked step, per lane within the benchmark check's latent limit,
and a FULL step's peak memory no higher than the full-batch step's
(``python -m pytest --noconftest -m cuda tests/test_torch_lanes.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import sampler as SM
from repro_torch.models import unet as U
from repro_torch.serving import config as CFG
from repro_torch.serving import lanes as LN
from repro_torch.serving.cache import CacheState
from repro_torch.serving.engine import EngineConfig, GenRequest

#: the engine's tolerance against the JAX package's (``test_torch_engine.py``)
TOL = 5e-4
#: the benchmark check's ``latent_err`` limit (``bench/limits/``)
LATENT_LIMIT = 1.5e-4
N = 4
MAX_STEPS = 8
CLASSES = {"full": SM.FULL, "sketch": SM.SKETCH, "refine": SM.REFINE}
MASKS = {"all": (0, 1, 2, 3), "some": (1, 3), "one": (2,)}
STATE_FIELDS = ("x", "ets", "n_ets", "f_sk", "f_rf", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clone(state: LN.LaneState) -> LN.LaneState:
    return LN.LaneState(**{f.name: None if getattr(state, f.name) is None
                           else getattr(state, f.name).clone() for f in dataclasses.fields(state)})


def _sel(lanes, n: int = N) -> torch.Tensor:
    sel = torch.zeros(n, dtype=torch.bool)
    sel[list(lanes)] = True
    return sel


def _fill(ucfg, dcfg, state: LN.LaneState, micro, seed: int, device="cpu") -> None:
    """Admit a request to every lane (plans of different lengths, an
    inpaint mask on lane 1), then FULL steps: two on every lane, one on
    the first half, so the lanes' steps, PNDM rings and captures differ."""
    n = state.n_lanes
    gen = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen).to(device)  # noqa: E731
    L, c = ucfg.latent_size**2, ucfg.in_channels
    for lane in range(n):
        plan = LN.make_plan_arrays(dcfg, MAX_STEPS - lane % 3, None, MAX_STEPS)
        mask = x_init = noise0 = None
        if lane == 1:
            mask = (torch.arange(L, device=device) < L // 2).float()[:, None]
            x_init, noise0 = r(L, c), r(L, c)
        LN.admit(state, lane, r(L, c), r(ucfg.ctx_len, ucfg.ctx_dim) * 0.2, plan,
                 mask, x_init, noise0)
    every = torch.ones(n, dtype=torch.bool, device=device)
    for _ in range(2):
        micro(state, SM.FULL, every)
    micro(state, SM.FULL, _sel(range(n // 2), n).to(device))


@pytest.fixture(scope="module")
def toy():
    """sd_toy weights, the micro-step, and four filled lanes."""
    ucfg, dcfg, params, _ = CFG.init_models(EngineConfig(device="cpu", decode_images=False,
                                                         max_steps=MAX_STEPS))
    n_up = U.n_up_steps(ucfg)
    e_sk, e_rf = n_up - 3, n_up - 2
    micro = LN.make_micro_step(ucfg, dcfg, params, e_sk, e_rf, device="cpu")
    state = LN.init_lanes(ucfg, N, MAX_STEPS, e_sk, e_rf, "cpu")
    _fill(ucfg, dcfg, state, micro, seed=28)
    return ucfg, dcfg, params, (e_sk, e_rf), micro, state


def _cache_args(state: LN.LaneState):
    """Every lane's threshold 0.3 and two slots of other features: lanes 1
    and 2 are handed slot 0 at a distance below it, lane 3 slot 1 at one
    above it."""
    gen = torch.Generator().manual_seed(5)
    cache = CacheState(
        f_sk=torch.randn((2, 2) + tuple(state.f_sk.shape[1:]), generator=gen),
        f_rf=torch.randn((2, 2) + tuple(state.f_rf.shape[1:]), generator=gen),
    )
    state.thr.fill_(0.3)
    src = torch.tensor([-1, 0, 0, 1])
    dist = torch.tensor([float("inf"), 0.1, 0.0, 0.5])
    return src, dist, cache


def _check_step(before, ref, got, lanes, n: int = N) -> None:
    """Advanced lanes within TOL of the masked step's; the others bitwise
    as they were before the step."""
    rows = list(lanes) + [n + i for i in lanes]
    for name in STATE_FIELDS:
        b, r, g = (getattr(s, name) for s in (before, ref, got))
        for i in range(b.shape[0]):
            mine = i in (rows if name in ("f_sk", "f_rf") else lanes)
            if mine:
                torch.testing.assert_close(g[i], r[i], atol=TOL, rtol=0,
                                           msg=lambda m: f"{name}[{i}]: {m}")
            else:
                assert torch.equal(g[i], b[i]), f"{name}[{i}] changed outside the mask"


def _ops(fn) -> set[str]:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("branch", CLASSES)
@pytest.mark.parametrize("cached", [False, True], ids=["own", "cached"])
def test_step_on_advancing_lanes_matches_the_masked_step(toy, branch, mask, cached):
    *_, micro, state = toy
    lanes = MASKS[mask]
    base = _clone(state)
    args = _cache_args(base) if cached else ()
    before, ref, got = _clone(base), _clone(base), _clone(base)
    sel = _sel(lanes)
    micro(ref, CLASSES[branch], sel, *args, n_advanced=len(lanes))
    idx = torch.tensor(lanes, dtype=torch.int64)
    ops = _ops(lambda: micro(got, CLASSES[branch], sel, *args, lanes=idx))
    _check_step(before, ref, got, lanes)
    if cached and branch == "sketch" and 1 in lanes:  # lane 1 adopted slot 0
        assert torch.equal(got.f_rf[1], args[2].f_rf[0, 0])
    if len(lanes) == N:  # every lane advances: the masked step itself, no gather
        for name in STATE_FIELDS:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert not ops & {"aten::index_select", "aten::index_copy_"}, ops
    else:
        assert {"aten::index_select", "aten::index_copy_"} <= ops


@pytest.fixture(scope="module")
def sharded_lanes(toy):
    """Two shards of two filled lanes, and the sharded micro-step."""
    ucfg, dcfg, params, (e_sk, e_rf), micro, _ = toy
    cpus = [torch.device("cpu")] * 2
    state = LN.init_sharded_lanes(ucfg, N, MAX_STEPS, e_sk, e_rf, cpus)
    for d, shard in enumerate(state.shards):
        _fill(ucfg, dcfg, shard, micro, seed=29 + d)
    sharded = LN.make_sharded_micro_step(ucfg, dcfg, {cpus[0]: params}, e_sk, e_rf, cpus)
    return sharded, state


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("branch", CLASSES)
def test_sharded_step_runs_each_shard_on_its_advancing_lanes(toy, sharded_lanes, branch, mask):
    """Each shard's advancing lanes, by shard-local index, against the
    masked single-device step on the same shard."""
    micro = toy[4]
    sharded, filled = sharded_lanes
    state = LN.ShardedLaneState([_clone(s) for s in filled.shards])
    ref = [_clone(s) for s in state.shards]
    before = [_clone(s) for s in state.shards]
    lanes = MASKS[mask]
    sel = np.zeros(N, bool)
    sel[list(lanes)] = True
    sharded(state, np.array([CLASSES[branch]] * 2), sel)
    for d, shard in enumerate(state.shards):
        mine = [i - 2 * d for i in lanes if i // 2 == d]
        if mine:
            micro(ref[d], CLASSES[branch], _sel(mine, 2))
        _check_step(before[d], ref[d], shard, mine, n=2)


def _stream(bundle, n: int = 6) -> list[GenRequest]:
    """Tiers draft / balanced / high over 6-8 steps on two prompts: the vote
    leaves lanes out, and a cache serves one request from another's captures."""
    u = bundle.ucfg
    rng = np.random.default_rng(28)
    prompts = rng.normal(size=(2, u.ctx_len, u.ctx_dim)).astype(np.float32)
    reqs = []
    for i in range(n):
        steps = 6 + i % 3
        pol = bundle.policy.resolve(steps, quality=("draft", "balanced", "high")[i % 3])
        reqs.append(GenRequest(
            rid=i, ctx=prompts[i % 2],
            noise=rng.normal(size=(u.latent_size**2, u.in_channels)).astype(np.float32),
            timesteps=steps, plan=pol.plan, policy=pol))
    return reqs


def _run(n_shards: int, cache: str):
    bundle = CFG.build_engine(EngineConfig(n_lanes=N, max_steps=MAX_STEPS, device="cpu",
                                           decode_images=False, n_shards=n_shards,
                                           cache_mode=cache))
    done, summary = bundle.engine.run(_stream(bundle))
    return {d.rid: d.latent for d in done}, summary


@pytest.mark.parametrize("n_shards, cache", [(1, "off"), (1, "cross"), (2, "off")],
                         ids=["single", "single-cross", "sharded"])
def test_engine_serves_as_with_the_masked_step(monkeypatch, n_shards, cache):
    got, summary = _run(n_shards, cache)
    build = LN.make_micro_step

    def masked(*a, **k):  # the micro-step as it was: one batch over every lane
        step = build(*a, **k)
        return lambda *args, lanes=None, **kw: step(*args, **kw)

    monkeypatch.setattr(LN, "make_micro_step", masked)
    want, ref = _run(n_shards, cache)
    assert sorted(got) == sorted(want) == list(range(6))
    for rid in want:
        np.testing.assert_allclose(got[rid], want[rid], atol=TOL, rtol=0, err_msg=f"rid={rid}")
    for key in ("micro_steps", "lane_steps_advanced", "full_steps", "sketch_steps",
                "refine_steps", "demoted_full_steps", "demoted_sketch_steps"):
        assert summary[key] == ref[key], key
    assert summary["lane_steps_computed"] == summary["lane_steps_advanced"]
    assert summary["lane_steps_advanced"] < summary["micro_steps"] * N  # the vote left lanes out
    if cache != "off":
        assert summary["demoted_full_steps"] + summary["demoted_sketch_steps"] > 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_on_three_of_eight_lanes(cuda_device):
    """sd_v14 on the ``cuda`` kernels, 8 lanes: each class on lanes 1, 4 and
    6 against the full-batch masked step, each lane's latent within the
    check's limit (max |difference| over the masked step's max |value|), the
    others bitwise; a FULL step's peak memory at most the full batch's."""
    config = EngineConfig(unet="sd_v14", device="cuda", backend="cuda", max_steps=MAX_STEPS,
                          decode_images=False)
    ucfg, dcfg, params, _ = CFG.init_models(config)
    n, lanes = 8, (1, 4, 6)
    n_up = U.n_up_steps(ucfg)
    e_sk, e_rf = n_up - 3, n_up - 2
    micro = LN.make_micro_step(ucfg, dcfg, params, e_sk, e_rf, device=cuda_device,
                               backend="cuda")
    state = LN.init_lanes(ucfg, n, MAX_STEPS, e_sk, e_rf, cuda_device)
    _fill(ucfg, dcfg, state, micro, seed=28, device=cuda_device)
    sel = _sel(lanes, n).to(cuda_device)
    idx = torch.tensor(lanes, dtype=torch.int64, device=cuda_device)
    peaks = {}
    for name, b in CLASSES.items():
        before, ref, got = _clone(state), _clone(state), _clone(state)
        for key, run in (("masked", lambda: micro(ref, b, sel, n_advanced=len(lanes))),
                         ("compact", lambda: micro(got, b, sel, lanes=idx))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            peaks[name, key] = torch.cuda.max_memory_allocated() - base
        for i in range(n):
            if i in lanes:
                err = float((got.x[i] - ref.x[i]).abs().max() / ref.x[i].abs().max())
                assert err <= LATENT_LIMIT, (name, i, err)
            else:
                assert torch.equal(got.x[i], before.x[i]), (name, i)
        print(name, {k: v for k, v in peaks.items() if k[0] == name})
    assert peaks["full", "compact"] <= peaks["full", "masked"]
