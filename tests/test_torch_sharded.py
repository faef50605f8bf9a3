"""The port's sharded engine against the JAX package's ``ShardedDiffusionEngine``.

The JAX engine needs one device a shard, and this suite's JAX has one, so
the reference runs once, in a subprocess of this file with two forced host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``), and
writes its latents and counters to a tmp ``.npz`` / ``.json``; the flag
never reaches another test file.  The port runs every shard on the CPU.

Streams (sd_toy, weights ``repro.serving.golden.golden_params()`` carried
across by ``repro_torch.bridge``):

* the golden stream (three requests over 2 lanes, PAS and all-FULL) on 2
  shards, cache off: latents within 5e-4, the JAX package's engine
  tolerance (measured headroom in ``CHANGES.md``), every counter equal;
* ``tests/test_serving_sharded.py``'s shard-local reuse stream (8
  same-prompt all-FULL requests, 4 lanes, ``cross``, one bucket over the
  whole ladder): latents within 5e-4, every cache counter equal, each hit
  on its own shard's ring;
* the warm-shard redirect with gossip on and off: the same shard and the
  same ``gossip_routed`` as the reference;
* the shared spill: a capture demoted off shard 0 promoted onto shard 1,
  with the reference's slots and counters.

Port-only: one shard is bitwise the single-device engine; threshold 0
with the spill is bitwise the cache off; admission fills the emptiest
shard; the metrics' shard balance and ``peek_warm_shard`` equal
``repro``'s on the same inputs; ``--shards`` is refused past the visible
cards and with ``--engine static``; the router forwards and sums the
sharded engine's flags and counter.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common.sharding import lane_mesh
from repro.serving import CacheAwareScheduler as JCacheAwareScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import GenRequest as JRequest
from repro.serving import golden as G
from repro.serving import metrics as JM
from repro.serving import scheduler as JS
from repro.serving.cache import ShardedFeatureCache as JShardedFeatureCache
from repro.serving.engine import ShardedDiffusionEngine as JShardedEngine
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.configs import get_unet_config
from repro_torch.serving import config as CFG
from repro_torch.serving import metrics as TM
from repro_torch.serving import scheduler as TS
from repro_torch.serving.cache import ShardedFeatureCache
from repro_torch.serving.engine import (
    DiffusionEngine,
    EngineConfig,
    GenRequest,
    ShardedDiffusionEngine,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 5e-4
#: summary counters that must be equal across the packages
COUNTERS = (
    "requests", "micro_steps", "lane_steps_advanced", "full_steps", "sketch_steps",
    "refine_steps", "demoted_full_steps", "demoted_sketch_steps", "hbm_hits",
    "spill_promotions", "gossip_routed", "shards", "lanes_per_shard", "shard_mean_active",
    "shard_occupancy_balance", "cache_shards", "cache_slots", "cache_warm_slots",
    "cache_probes", "cache_probe_hits", "cache_inserts", "cache_evictions",
    "shard_hit_rates", "cache_spill_demotions", "cache_spill_promotions",
)


def _request(GenRequest, ucfg, rid, t, plan, seed=None, ctx=None):
    """``tests/test_serving_sharded.py``'s request builder, for either package."""
    rng = np.random.default_rng(300 + (seed if seed is not None else rid))
    return GenRequest(
        rid=rid,
        ctx=ctx if ctx is not None
        else rng.normal(size=(ucfg.ctx_len, ucfg.ctx_dim)).astype(np.float32) * 0.2,
        noise=rng.normal(size=(ucfg.latent_size**2, ucfg.in_channels)).astype(np.float32),
        timesteps=t,
        plan=plan,
    )


def _reuse_stream(GenRequest, ucfg):
    ctx = np.random.default_rng(9).normal(size=(ucfg.ctx_len, ucfg.ctx_dim)) * 0.2
    return [_request(GenRequest, ucfg, i, 5, None, seed=70 + i, ctx=ctx.astype(np.float32))
            for i in range(8)]


#: sd_toy's cache geometry (of its 6 up-steps): entry steps 3 and 4
L_SKETCH, L_REFINE, E_SK, E_RF = 3, 2, 3, 4


def _configs(EngineConfig, **extra):
    """{stream: engine config} of the streams run through both packages."""
    geo = dict(l_sketch=L_SKETCH, l_refine=L_REFINE, decode_images=False, n_shards=2)
    reuse = dict(max_steps=8, cache_mode="cross", cache_slots=4, cache_threshold=0.25,
                 cache_t_bucket=1000, **geo, **extra)
    return {
        "golden": EngineConfig(n_lanes=2, **geo, max_steps=8, **extra),
        "reuse": EngineConfig(n_lanes=4, **reuse),
        "gossip_on": EngineConfig(n_lanes=4, **reuse),
        "gossip_off": EngineConfig(n_lanes=4, cache_gossip=False, **reuse),
    }


def _gossip_probe(engine, GenRequest, ucfg):
    """Warm shard 1 with a foreign slot matching a queued request, backfill
    once -> (shard of the admitted lane, gossip_routed)."""
    req = _request(GenRequest, ucfg, 0, 5, None, seed=70)
    engine.submit(req)
    assert engine.cache.rings[1].reserve(int(req._lane_plan.ts[1]), req._sig, rid=999) == 0
    engine._backfill(0.0)
    lanes = [i for i, r in enumerate(engine._lane_req) if r is not None]
    assert len(lanes) == 1
    return engine._shard_of(lanes[0]), engine.metrics.gossip_routed


def _spill_probe(cache_cls, ucfg, devices_or_mesh) -> dict:
    """``test_sharded_shared_spill_promotes_across_shards``'s steps on a
    2-shard cache of 1 slot a shard, ring buckets of width 1."""
    c = cache_cls(ucfg, E_SK, E_RF, devices_or_mesh, slots_per_shard=1,
                  threshold=0.25, t_bucket=1, mode="cross", spill_mb=4)
    sig = np.random.default_rng(4).normal(size=(ucfg.ctx_dim,)).astype(np.float32)
    out = dict(first=c.rings[0].reserve(1, sig, rid=1),
               evicting=c.rings[0].reserve(2, 10 * sig, rid=2),
               demotions=c.spill.demotions, on_shard0=c.probe(0, 1, sig, rid=9))
    out.update(promoted=c.promote(1, 1, sig, rid=9), on_shard1=c.probe(1, 1, sig, rid=9),
               as_owner=c.probe(1, 1, sig, rid=1), version=c.version, stats=c.stats())
    return out


def reference(npz_path: str, json_path: str) -> None:
    """The JAX package's side: every stream above on 2 devices (run as
    ``python tests/test_torch_sharded.py NPZ JSON`` with two forced host
    devices)."""
    assert len(jax.devices()) == 2, jax.devices()
    params, ucfg = G.golden_params(), G.UCFG
    assert (G.L_SKETCH, G.L_REFINE, ucfg.name) == (L_SKETCH, L_REFINE, "sd_toy")
    configs = _configs(JEngineConfig)
    out, latents = {}, {}
    for name, reqs, sched in (
        ("golden", G.golden_requests(), None),
        ("reuse", _reuse_stream(JRequest, ucfg), JCacheAwareScheduler(window=2)),
    ):
        eng = JShardedEngine(ucfg, G.DCFG, params, None, configs[name], scheduler=sched)
        done, summary = eng.run(reqs)
        out[name] = {k: summary[k] for k in COUNTERS if k in summary}
        out[name]["ring_hits"] = [r.probe_hits for r in eng.cache.rings] if eng.cache else None
        latents.update({f"{name}_{d.rid}": d.latent for d in done})
    for name in ("gossip_on", "gossip_off"):
        eng = JShardedEngine(ucfg, G.DCFG, params, None, configs[name],
                             scheduler=JCacheAwareScheduler(window=2))
        out[name] = _gossip_probe(eng, JRequest, ucfg)
    out["spill"] = _spill_probe(JShardedFeatureCache, ucfg, lane_mesh(2))
    np.savez(npz_path, **latents)
    with open(json_path, "w") as f:
        json.dump(out, f, default=_plain)


def _plain(o):
    """numpy scalars as Python numbers, for ``json``."""
    return o.item()


TOY = get_unet_config("sd_toy")
DCFG = DiffusionConfig(**dataclasses.asdict(G.DCFG))
#: the reference subprocess's limit: it takes about 50 s alone and 95 s
#: beside five other test workers
REF_TIMEOUT_S = 360


def two_device_env(src: str) -> dict:
    """This process's environment for a JAX subprocess with two host
    devices: a device count already in ``XLA_FLAGS`` (another test module
    may have imported one into this process) is replaced, not appended to,
    since XLA takes the last."""
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count=")]
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS=" ".join(["--xla_force_host_platform_device_count=2", *flags]),
                PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def params():
    return bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, G.golden_params()))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(latents, counters) of the JAX package's run, made once."""
    d = tmp_path_factory.mktemp("sharded_ref")
    npz, js = str(d / "ref.npz"), str(d / "ref.json")
    out = subprocess.run([sys.executable, os.path.abspath(__file__), npz, js],
                         env=two_device_env(os.path.join(REPO, "src")),
                         cwd=REPO, capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(js) as f:
        return dict(np.load(npz)), json.load(f)


def _port_requests():
    return [GenRequest(rid=r.rid, ctx=r.ctx, noise=r.noise, timesteps=r.timesteps,
                       plan=None if r.plan is None else PASPlan(**dataclasses.asdict(r.plan)))
            for r in G.golden_requests()]


def _port_run(params, name):
    cfg = _configs(EngineConfig, device="cpu")[name]
    reqs = _port_requests() if name == "golden" else _reuse_stream(GenRequest, TOY)
    sched = None if name == "golden" else TS.CacheAwareScheduler(window=2)
    eng = ShardedDiffusionEngine(TOY, DCFG, params, None, cfg, scheduler=sched)
    done, summary = eng.run(reqs)
    return eng, {d.rid: d.latent for d in done}, summary


@pytest.mark.parametrize("name", ["golden", "reuse"])
def test_two_shards_match_jax(ref, params, name):
    latents, counters = ref
    eng, got, summary = _port_run(params, name)
    want = {k: v for k, v in counters[name].items() if k != "ring_hits"}
    assert {k: summary.get(k) for k in want} == want
    assert summary["mode"] == "sharded-continuous" and summary["devices"] == ["cpu", "cpu"]
    assert sorted(got) == sorted(int(k.rsplit("_", 1)[1]) for k in latents if k.startswith(name))
    for rid, lat in got.items():
        assert np.isfinite(lat).all()
        np.testing.assert_allclose(lat, latents[f"{name}_{rid}"], atol=TOL, rtol=0,
                                   err_msg=f"{name} rid={rid}")
    if name == "reuse":
        # reuse stays shard-local: each hit on the consumer's own ring
        assert summary["cache_probe_hits"] > 0
        assert [r.probe_hits for r in eng.cache.rings] == counters[name]["ring_hits"]
        assert summary["cache_probe_hits"] == sum(r.probe_hits for r in eng.cache.rings)
        assert summary["cache_probes"] == sum(r.probes for r in eng.cache.rings)
        assert summary["shard_occupancy_balance"] > 0.0


@pytest.mark.parametrize("gossip", ["gossip_on", "gossip_off"])
def test_gossip_redirect_matches_jax(ref, params, gossip):
    cfg = _configs(EngineConfig, device="cpu")[gossip]
    eng = ShardedDiffusionEngine(TOY, DCFG, params, None, cfg,
                                 scheduler=TS.CacheAwareScheduler(window=2))
    got = _gossip_probe(eng, GenRequest, TOY)
    assert list(got) == ref[1][gossip]
    assert got == ((1, 1) if gossip == "gossip_on" else (0, 0))


def test_shared_spill_promotes_across_shards_as_jax(ref):
    got = _spill_probe(ShardedFeatureCache, TOY, [torch.device("cpu")] * 2)
    assert got["demotions"] == 1 and got["on_shard0"] is None
    assert (got["promoted"], got["on_shard1"], got["as_owner"]) == (0, 0, None)
    assert got["stats"]["cache_spill_promotions"] == 1
    assert json.loads(json.dumps(got, default=_plain)) == ref[1]["spill"]


@pytest.mark.parametrize("cache", ["off", "cross"])
def test_one_shard_is_bitwise_the_single_device_engine(params, cache):
    extra = {} if cache == "off" else dict(cache_mode="cross", cache_slots=2,
                                           cache_threshold=0.25, cache_spill_mb=1)
    cfg = dataclasses.replace(_configs(EngineConfig, device="cpu")["golden"], n_shards=1,
                              **extra)
    runs = []
    for cls in (DiffusionEngine, ShardedDiffusionEngine):
        done, summary = cls(TOY, DCFG, params, None, cfg, scheduler=CFG.default_scheduler(cfg)
                            ).run(_port_requests())
        runs.append(({d.rid: d.latent for d in done}, summary))
    (single, s1), (sharded, s2) = runs
    assert sorted(single) == sorted(sharded) == [0, 1, 2]
    for rid in single:
        np.testing.assert_array_equal(sharded[rid], single[rid])
    same = ("micro_steps", "full_steps", "sketch_steps", "refine_steps", "cache_probes",
            "cache_probe_hits", "cache_spill_demotions")
    assert {k: s2.get(k) for k in same} == {k: s1.get(k) for k in same}
    assert s2["shards"] == 1


def test_threshold_zero_with_spill_is_bitwise_cache_off(params):
    def mk():
        return [_request(GenRequest, TOY, i, 4 + i % 2, _plan_for(4 + i % 2), seed=90 + i)
                for i in range(4)]

    common = dict(n_lanes=4, max_steps=8, l_sketch=L_SKETCH, l_refine=L_REFINE, decode_images=False,
                  n_shards=2, device="cpu")
    base = ShardedDiffusionEngine(TOY, DCFG, params, None, EngineConfig(**common)).run(mk())[0]
    cfg = EngineConfig(**common, cache_mode="cross", cache_threshold=0.0, cache_slots=1,
                       cache_spill_mb=16)
    done, summary = ShardedDiffusionEngine(TOY, DCFG, params, None, cfg).run(mk())
    assert summary["demoted_full_steps"] == summary["spill_promotions"] == 0
    assert summary["cache_spill_demotions"] > 0  # the spill ran, and never served
    want = {d.rid: d.latent for d in base}
    assert sorted(d.rid for d in done) == sorted(want)
    for d in done:
        np.testing.assert_array_equal(d.latent, want[d.rid])


def test_scenarios_through_the_sharded_engine(params):
    """The conditioned scenarios (img2img, inpaint, variations): one shard
    bitwise the single-device engine, two shards on the straight line."""
    from repro_torch.serving import scenarios as SC

    one = SC.run_sharded_engine(params, n_shards=1, device="cpu")
    single = SC.run_engine(params, device="cpu")
    two = SC.run_sharded_engine(params, n_shards=2, device="cpu")
    line = SC.run_straight_line(params, device="cpu")
    assert sorted(one) == sorted(single) == sorted(two) == sorted(line)
    for name in line:
        np.testing.assert_array_equal(one[name], single[name], err_msg=name)
        np.testing.assert_allclose(two[name], line[name], atol=TOL, rtol=0, err_msg=name)


def _plan_for(t):
    return None if t % 2 else PASPlan(t_sketch=max(2, t // 2 + 1), t_complete=2, t_sparse=2,
                                      l_sketch=L_SKETCH, l_refine=L_REFINE)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_backfill_fills_the_emptiest_shard_first(params, n_shards):
    cfg = EngineConfig(n_lanes=2 * n_shards, max_steps=8, l_sketch=L_SKETCH, l_refine=L_REFINE,
                       decode_images=False, n_shards=n_shards, device="cpu")
    eng = ShardedDiffusionEngine(TOY, DCFG, params, None, cfg)
    for i in range(n_shards):
        eng.submit(_request(GenRequest, TOY, i, 4, None, seed=40 + i))
    eng._backfill(0.0)
    per_shard = [0] * n_shards
    for lane, req in enumerate(eng._lane_req):
        if req is not None:
            per_shard[eng._shard_of(lane)] += 1
    assert per_shard == [1] * n_shards


@pytest.mark.parametrize("steps", [
    [(4, 3, 3, [2, 1]), (4, 4, 4, [2, 2])],
    [(4, 2, 1, [0, 2]), (4, 1, 1, [0, 1]), (4, 3, 2, [1, 2])],
    [(4, 2, 2, None)],
])
def test_shard_summary_equals_jax(steps):
    got, want = TM.ServingMetrics(), JM.ServingMetrics()
    for n, act, adv, shards in steps:
        got.record_step(n, act, adv, shard_active=shards)
        want.record_step(n, act, adv, shard_active=shards)
    assert got._shard_summary() == want._shard_summary()
    assert ("shard_occupancy_balance" in got.summary()) == (steps[0][3] is not None)


@dataclasses.dataclass
class _FakeReq:
    rid: int
    branches: np.ndarray

    def branch_vector(self):
        return self.branches


class _FakeShardedCache:
    """Warmth by (rid, shard): rid 0 warm on shard 1 only, rid 2 half-warm everywhere."""

    n_warm = 1

    def plan_warmth(self, req, shard=None):
        table = {0: {0: 0.0, 1: 1.0}, 2: {0: 0.5, 1: 0.5}}.get(req.rid, {})
        return max(table.values(), default=0.0) if shard is None else table.get(shard, 0.0)


@pytest.mark.parametrize("shards", [[0, 1], [0], [1], []])
@pytest.mark.parametrize("rids", [[0, 1], [1, 2], [1], [2, 0]])
def test_peek_warm_shard_and_admission_equal_jax(shards, rids):
    outs = []
    for pkg in (TS, JS):
        s = pkg.CacheAwareScheduler(window=4)
        s.attach_cache(_FakeShardedCache())
        for rid in rids:
            s.add(_FakeReq(rid, np.asarray([rid % 3] * 3, np.int32)))
        picks = [s.next_request([np.zeros(3, np.int32)], shard=sh).rid
                 for sh in (1, 0)[: len(rids)]]
        outs.append((s.peek_warm_shard(shards), picks))
    assert outs[0] == outs[1]


def test_check_shards_available_messages():
    CFG.check_shards_available(1, "cuda")
    CFG.check_shards_available(7, "cpu")  # every shard on the CPU
    if torch.cuda.device_count() < 2:
        with pytest.raises(SystemExit, match="--shards 2 needs 2 visible devices but only"):
            CFG.check_shards_available(2, "cuda")
    with pytest.raises(SystemExit, match="needs 99 visible devices"):
        CFG.check_shards_available(99, "cuda:0")


def test_build_engine_builds_the_sharded_engine_on_the_cpu(params):
    cfg = EngineConfig(n_shards=2, device="cpu", n_lanes=4, max_steps=8, decode_images=False)
    bundle = CFG.build_engine(cfg, models=(TOY, DCFG, params, None))
    assert type(bundle.engine) is ShardedDiffusionEngine
    assert bundle.engine.devices == [torch.device("cpu")] * 2
    # one weight tree for the two shards of one device
    assert bundle.engine._params_on == {torch.device("cpu"): params}


def _serve(*flags):
    # one thread: a multi-threaded torch in a crowded test worker spins
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--requests", "3",
         "--batch", "2", "--timesteps", "4", "--shards", "2", *flags],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )


def test_serve_cli_sharded_on_the_cpu():
    out = _serve("--cache", "cross", "--no-cache-gossip")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'shards': 2" in out.stdout and "'lanes_per_shard': 1" in out.stdout
    assert "'mode': 'diffusion'" in out.stdout


def test_serve_cli_refuses_static_shards():
    out = _serve("--engine", "static")
    assert out.returncode != 0
    assert "--shards requires the continuous engine" in out.stderr


def test_replica_command_forwards_shards_and_gossip():
    from repro_torch.launch import router as LR
    from repro_torch.launch import serve as SERVE

    for flags in ([], ["--shards", "2"], ["--shards", "2", "--no-cache-gossip"]):
        cmd = LR.replica_command(LR.build_parser().parse_args(["--device", "cpu", *flags]))
        got = SERVE.build_parser().parse_args(cmd[3:])
        want = SERVE.build_parser().parse_args(["--device", "cpu", *flags])
        assert (got.shards, got.cache_gossip) == (want.shards, want.cache_gossip)
        assert ("--shards" in cmd) == ("--shards" in flags)
        assert ("--no-cache-gossip" in cmd) == ("--no-cache-gossip" in flags)


def test_router_sums_gossip_routed_as_the_reference():
    """The engine's ``gossip_routed`` is relayed per replica and summed over
    the fleet, as ``repro``'s router does."""
    from repro.serving import router as JR
    from repro_torch.serving import router as TR

    assert TR.REPLICA_STAT_KEYS == JR.REPLICA_STAT_KEYS
    assert TR.FLEET_SUM_KEYS == JR.FLEET_SUM_KEYS
    assert "gossip_routed" in TR.FLEET_SUM_KEYS


if __name__ == "__main__":
    reference(*sys.argv[1:])
