"""``chip_smoke.py`` phase 6's stream at sd_toy: the port's engine against the JAX package's.

Phase 6 serves one stream on the card that mixes the donor / churn / twin
spill pattern, a K=3 variation group, img2img at two strengths, a half-mask
inpaint and ``exact`` / ``draft`` requests, on a ``cross`` engine with a
3-slot ring over a 4-slot spill.  The card's run is held only against the
port's own plain backend there, so here the same stream (built by
``chip_smoke.phase6_stream`` with each package's request, plan and policy
types) runs through ``repro.serving``'s engine and the port's on the same
bridged weights, with the cache on and off.

Latents agree within 5e-4, the engine tolerance of the JAX package's own
differential tests; every cache, demotion and spill counter is *equal*, so
the counters phase 6 requires of the card come from the reference.
"""
import dataclasses
import importlib.util
import math
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.configs import get_unet_config
from repro.models import unet as JU
from repro.serving import GenRequest as JRequest
from repro.serving import config as JCFG
from repro.serving.engine import EngineConfig as JConfig
from repro.serving.policy import default_pas_plan as j_default_pas_plan
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig
from repro_torch.core import sampler as SM
from repro_torch.serving import config as TCFG
from repro_torch.serving.engine import EngineConfig, GenRequest
from repro_torch.serving.policy import default_pas_plan as t_default_pas_plan

TOY = get_unet_config("sd_toy")
N_UP = JU.n_up_steps(TOY)
TOL = 5e-4
#: summary keys besides chip_smoke.P6_COUNTERS that must be equal too
MORE_COUNTERS = ("micro_steps", "lane_steps_advanced", "cache_warm_slots",
                 "cache_spill_entries", "cache_spill_bytes", "cache_spill_evictions")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(cfg_cls, **extra):
    """(cached, cache-off) engine configs of phase 6 at sd_toy."""
    base = cfg_cls(n_lanes=CS.N_LANES, max_steps=CS.MAX_STEPS, l_sketch=3, l_refine=2,
                   decode_images=False, unet="sd_toy", **extra)
    slot_bytes = 8 * sum(math.prod(SM.feat_shape(TOY, e, 1)) for e in (N_UP - 3, N_UP - 2))
    cached = dataclasses.replace(
        base, cache_spill_mb=CS.P6_SPILL_SLOTS * slot_bytes / 2**20 * 1.001, **CS.P6_CACHE)
    return {"cached": cached, "off": base}


def _serve(pkg_cfg, configs, models, request_cls, default_pas_plan):
    out = {}
    for name, cfg in configs.items():
        policy = pkg_cfg.build_policy(configs["cached"], models[0], models[1])
        reqs = [r for _, r in CS.phase6_stream(
            np, TOY, N_UP, policy, request_cls, default_pas_plan)]
        done, summary = pkg_cfg.build_engine(cfg, models=models).engine.run(reqs)
        out[name] = ({d.rid: d.latent for d in done}, summary)
    return out


@pytest.fixture(scope="module")
def runs():
    """{package: {cached|off: (latents by rid, summary)}}, each run once."""
    jparams = jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(0), TOY)
    tparams = bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    jmodels = (TOY, JDiffusionConfig(timesteps_sample=CS.MAX_STEPS), jparams, None)
    tmodels = (TOY, DiffusionConfig(timesteps_sample=CS.MAX_STEPS), tparams, None)
    return {
        "jax": _serve(JCFG, _configs(JConfig), jmodels, JRequest, j_default_pas_plan),
        "port": _serve(TCFG, _configs(EngineConfig, device="cpu"), tmodels, GenRequest,
                       t_default_pas_plan),
    }


@pytest.mark.parametrize("cache", ["cached", "off"])
def test_phase6_stream_latents_match_jax(runs, cache):
    ref, _ = runs["jax"][cache]
    got, _ = runs["port"][cache]
    assert sorted(got) == sorted(ref) == list(range(runs["jax"][cache][1]["requests"]))
    for rid in ref:
        assert np.isfinite(got[rid]).all()
        np.testing.assert_allclose(got[rid], ref[rid], atol=TOL, rtol=0, err_msg=f"rid={rid}")


@pytest.mark.parametrize("cache", ["cached", "off"])
def test_phase6_stream_counters_equal_jax(runs, cache):
    ref, got = runs["jax"][cache][1], runs["port"][cache][1]
    keys = [k for k in CS.P6_COUNTERS + MORE_COUNTERS if k in ref]
    assert {k: got.get(k) for k in keys} == {k: ref[k] for k in keys}
    if cache == "cached":
        assert set(CS.P6_COUNTERS) <= set(keys)


def test_phase6_stream_exercises_every_reuse_on_the_reference(runs):
    """What phase 6 requires of the card holds on the JAX engine: both kinds
    of demotion, spill demotions and promotions, and FULL passes saved."""
    cached, off = runs["jax"]["cached"][1], runs["jax"]["off"][1]
    for key in ("demoted_full_steps", "demoted_sketch_steps", "cache_spill_demotions",
                "spill_promotions"):
        assert cached[key] > 0, key
    assert cached["full_steps"] < off["full_steps"]
    assert off["demoted_full_steps"] == 0 and "cache_spill_demotions" not in off
