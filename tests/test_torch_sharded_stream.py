"""``chip_smoke.py`` phase 10's two-shard stream at sd_toy: the port's engine against the JAX package's.

Phase 10 serves phase 6's stream (donor / churn / twin, K=3 variations,
img2img at two strengths, a half-mask inpaint, ``exact`` / ``draft``) on
a two-shard ``cross`` engine (4 lanes, a 3-slot ring a shard, one shared
spill ring, ``cache_gossip``), and requires of the card at least one
admission redirected to a warm shard, one spill promotion onto another
shard than the one that demoted it, and one step whose shard votes
differ.  Those are host decisions, so the same stream at sd_toy predicts
them: here it runs through ``repro``'s ``ShardedDiffusionEngine`` (in one
subprocess of this file with two forced host devices, since the suite's
JAX has one) and through the port's (both shards on the CPU), on the same
bridged weights, each counted by ``chip_smoke.track_sharded``.

Latents agree within 5e-4, the JAX package's engine tolerance; every
counter is *equal*, so the counters phase 10 requires of the card come
from the reference, pinned below.
"""
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.models import unet as JU
from repro.serving import GenRequest as JRequest
from repro.serving import config as JCFG
from repro.serving.engine import EngineConfig as JConfig
from repro.serving.policy import default_pas_plan as j_default_pas_plan
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import get_unet_config
from repro_torch.core import sampler as SM
from repro_torch.serving import config as TCFG
from repro_torch.serving.engine import EngineConfig, GenRequest
from repro_torch.serving.policy import default_pas_plan as t_default_pas_plan

REPO = pathlib.Path(__file__).resolve().parents[1]
TOY = get_unet_config("sd_toy")
N_UP = JU.n_up_steps(TOY)
TOL = 5e-4
#: summary keys besides chip_smoke.P10_COUNTERS that must be equal too
MORE_COUNTERS = ("micro_steps", "lane_steps_advanced", "cache_warm_slots",
                 "cache_spill_entries", "cache_spill_bytes", "cache_spill_evictions",
                 "shard_occupancy_balance", "shards", "lanes_per_shard")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


def _config(cfg_cls, **extra):
    """Phase 10's cached engine config at sd_toy."""
    base = cfg_cls(n_lanes=CS.N_LANES, max_steps=CS.MAX_STEPS, l_sketch=3, l_refine=2,
                   decode_images=False, unet="sd_toy", **extra)
    slot_bytes = 8 * sum(math.prod(SM.feat_shape(TOY, e, 1)) for e in (N_UP - 3, N_UP - 2))
    return CS.phase10_config(base, slot_bytes)


def _serve(pkg_cfg, cfg, models, request_cls, default_pas_plan):
    """(latents by rid, summary, tracked counts) of phase 10's stream."""
    policy = pkg_cfg.build_policy(cfg, models[0], models[1])
    reqs = [r for _, r in CS.phase6_stream(np, TOY, N_UP, policy, request_cls, default_pas_plan)]
    engine = pkg_cfg.build_engine(cfg, models=models).engine
    tracked = CS.track_sharded(engine)
    done, summary = engine.run(reqs)
    return {d.rid: d.latent for d in done}, summary, tracked


def _jax_params():
    return jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(0), TOY)


def reference(npz_path: str, json_path: str) -> None:
    """The JAX package's side, on two devices (run as ``python
    tests/test_torch_sharded_stream.py NPZ JSON`` with two forced host
    devices)."""
    assert len(jax.devices()) == 2, jax.devices()
    models = (TOY, JDiffusionConfig(timesteps_sample=CS.MAX_STEPS), _jax_params(), None)
    latents, summary, tracked = _serve(JCFG, _config(JConfig), models, JRequest,
                                       j_default_pas_plan)
    np.savez(npz_path, **{str(rid): lat for rid, lat in latents.items()})
    keys = CS.P10_COUNTERS + MORE_COUNTERS + ("requests",)
    with open(json_path, "w") as f:
        json.dump(dict(summary={k: summary[k] for k in keys if k in summary}, tracked=tracked),
                  f)


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
def runs(tmp_path_factory):
    """{package: (latents by rid, summary, tracked counts)}, each run once."""
    d = tmp_path_factory.mktemp("sharded_stream_ref")
    npz, js = str(d / "ref.npz"), str(d / "ref.json")
    out = subprocess.run([sys.executable, __file__, npz, js],
                         env=two_device_env(str(REPO / "src")), cwd=REPO,
                         capture_output=True, text=True, timeout=360)  # ~90 s in the suite
    assert out.returncode == 0, out.stderr[-3000:]
    with open(js) as f:
        ref = json.load(f)
    ref_latents = {int(k): v for k, v in np.load(npz).items()}
    tparams = bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, _jax_params()))
    tmodels = (TOY, DiffusionConfig(timesteps_sample=CS.MAX_STEPS), tparams, None)
    return {
        "jax": (ref_latents, ref["summary"], ref["tracked"]),
        "port": _serve(TCFG, _config(EngineConfig, device="cpu"), tmodels, GenRequest,
                       t_default_pas_plan),
    }


def test_phase10_stream_latents_match_jax(runs):
    ref, got = runs["jax"][0], runs["port"][0]
    assert sorted(got) == sorted(ref) == list(range(runs["jax"][1]["requests"]))
    for rid in ref:
        assert np.isfinite(got[rid]).all()
        np.testing.assert_allclose(got[rid], ref[rid], atol=TOL, rtol=0, err_msg=f"rid={rid}")


def test_phase10_stream_counters_equal_jax(runs):
    ref, got = runs["jax"][1], runs["port"][1]
    keys = [k for k in CS.P10_COUNTERS + MORE_COUNTERS if k in ref]
    assert set(CS.P10_COUNTERS) <= set(keys)
    assert {k: json.loads(json.dumps(got.get(k))) for k in keys} == {k: ref[k] for k in keys}
    assert runs["port"][2] == runs["jax"][2]


def test_phase10_stream_exercises_the_sharded_paths_on_the_reference(runs):
    """What phase 10 requires of the card holds on the JAX engine, with
    these counts: a redirect to a warm shard, a cross-shard spill
    promotion, shard votes that differ, and FULL passes served from the
    rings."""
    summary, tracked = runs["jax"][1], runs["jax"][2]
    assert summary["gossip_routed"] >= 1
    assert tracked["cross"] >= 1 and tracked["split"] >= 1
    pinned = dict(gossip_routed=summary["gossip_routed"], full_steps=summary["full_steps"],
                  demoted_full_steps=summary["demoted_full_steps"],
                  spill_promotions=summary["spill_promotions"],
                  cache_spill_demotions=summary["cache_spill_demotions"], **tracked)
    assert pinned == dict(gossip_routed=2, full_steps=28, demoted_full_steps=2,
                          spill_promotions=1, cache_spill_demotions=23, split=9,
                          promotions=1, cross=1)


def test_phase10_config_is_phase6s_ring_over_two_shards():
    cfg = _config(EngineConfig, device="cpu")
    assert (cfg.n_lanes, cfg.n_shards, cfg.cache_slots, cfg.cache_gossip) == (4, 2, 3, True)
    # a shard's lanes are phase 3's, so its U-Net calls run at phase 3's shapes
    assert cfg.n_lanes // cfg.n_shards == CS.N_LANES


if __name__ == "__main__":
    reference(*sys.argv[1:])
