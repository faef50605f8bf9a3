"""The port's sampler and continuous engine against the JAX package's.

Weights are ``repro``'s ``U.init_unet(jax.random.key(0), TOY)`` carried
across by ``repro_torch.bridge``; the request stream is
``repro.serving.golden.golden_requests()`` (three sd_toy requests mixing PAS
plans, a shorter plan and an all-FULL request over 2 lanes, max 8 steps).
Tolerances: 2e-4 for the straight-line sampler and 5e-4 for the engine,
the JAX package's own (``test_golden_latents.py``,
``test_serving_differential.py``); measured 5.6e-5 (sampler) and 5.7e-5
(engine) on latents of up to 22.5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampler as JSM
from repro.models import unet as JU
from repro.serving import golden as G
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.configs import get_unet_config
from repro_torch.core import sampler as TSM
from repro_torch.serving import config as CFG
from repro_torch.serving.engine import DiffusionEngine, EngineConfig, GenRequest

TOY = get_unet_config("sd_toy")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """sd_toy tensors are small: one intra-op thread keeps this module from
    crowding the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_plan(plan):
    return None if plan is None else PASPlan(**dataclasses.asdict(plan))


def _port_requests():
    return [
        GenRequest(
            rid=r.rid, ctx=r.ctx, noise=r.noise, timesteps=r.timesteps, plan=_port_plan(r.plan)
        )
        for r in G.golden_requests()
    ]


def _engine_config(**kw) -> EngineConfig:
    return EngineConfig(
        n_lanes=G.N_LANES, max_steps=G.MAX_STEPS, l_sketch=G.L_SKETCH, l_refine=G.L_REFINE,
        decode_images=False, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def weights():
    jparams = jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(0), G.UCFG)
    return jparams, bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("rid", [0, 2])  # a PAS plan, and all-FULL
def test_pas_denoise_matches_jax(weights, rid):
    req = G.golden_requests()[rid]
    jd = dataclasses.replace(G.DCFG, timesteps_sample=req.timesteps)
    zeros = np.zeros((1, TOY.ctx_len, TOY.ctx_dim), np.float32)
    ref = JSM.pas_denoise(
        G.UCFG, jd, weights[0], req.plan,
        jnp.asarray(req.noise)[None], jnp.asarray(req.ctx)[None], jnp.asarray(zeros),
    )
    td = DiffusionConfig(**dataclasses.asdict(jd))
    got = TSM.pas_denoise(
        TOY, td, weights[1], _port_plan(req.plan),
        torch.from_numpy(req.noise)[None], torch.from_numpy(req.ctx)[None],
        torch.from_numpy(zeros),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=0)


def test_plan_to_branches_matches_jax():
    for t in (4, 6, 8, 13):
        for plan in (
            PASPlan(t // 2 + 1, 2, 2, 3, 2), PASPlan(t, 1, 3, 2, 2), PASPlan(2, 2, 1, 4, 1)
        ):
            jplan = G.PASPlan(**dataclasses.asdict(plan))
            ref = np.asarray(JSM.plan_to_branches(jplan, t)).tolist()
            assert TSM.plan_to_branches(plan, t) == ref


def test_engine_matches_jax_engine(weights):
    ref = G.run_engine(weights[0])
    engine = DiffusionEngine(
        TOY, DiffusionConfig(**dataclasses.asdict(G.DCFG)), weights[1], None, _engine_config()
    )
    done, summary = engine.run(_port_requests())
    assert summary["kernels"] == "eager" and summary["device"] == "cpu"
    assert summary["sketch_steps"] + summary["refine_steps"] > 0  # partial branches ran
    got = {d.rid: d.latent for d in done}
    assert sorted(got) == sorted(ref)
    for rid in ref:
        np.testing.assert_allclose(got[rid], ref[rid], atol=5e-4, rtol=0, err_msg=f"rid={rid}")


def test_build_engine_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        CFG.build_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        CFG.build_engine(EngineConfig(unet="sd_toy"))


def test_cpu_device_with_cuda_kernels_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        EngineConfig(device="cpu", backend="cuda")
    assert EngineConfig(device="cpu").kernels == "eager"
    assert EngineConfig().kernels == "cuda"


@pytest.mark.parametrize("kw", [dict(n_shards=2)], ids=["sharded"])
def test_engine_config_refuses_unported(kw):
    """Only the sharded engine (and with it the sharded cache) is unported."""
    with pytest.raises(ValueError, match="not yet ported"):
        _engine_config(**kw)


@pytest.mark.parametrize("mode", ["off", "intra", "cross"])
def test_engine_config_accepts_cache_modes(mode):
    assert _engine_config(cache_mode=mode).cache_mode == mode
    with pytest.raises(ValueError, match="off\\|intra\\|cross"):
        _engine_config(cache_mode=mode + "x")


@pytest.mark.parametrize("field", ["mask", "init_latent", "policy"])
def test_engine_refuses_conditioned_requests(field):
    """Malformed conditioned requests are refused at submit (well-formed
    ones are served: tests/test_torch_scenarios.py)."""
    bundle = CFG.build_engine(_engine_config())
    req = _port_requests()[0]
    bad = {
        "mask": (np.ones((7, 1), np.float32), ValueError, "mask shape"),
        "init_latent": (np.ones((3, 4), np.float32), ValueError, "init latent shape"),
        "policy": (object(), TypeError, "ResolvedPolicy"),
    }[field]
    setattr(req, field, bad[0])
    with pytest.raises(bad[1], match=bad[2]):
        bundle.engine.submit(req)
    if field == "mask":
        req.mask = np.full((TOY.latent_size**2,), 1.5, np.float32)
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            bundle.engine.submit(req)


def test_build_engine_serves_on_cpu():
    """The construction path end to end: own weights, decode, summary."""
    cfg = dataclasses.replace(_engine_config(), decode_images=True, max_steps=4)
    bundle = CFG.build_engine(cfg)
    rng = np.random.default_rng(0)
    reqs = [
        GenRequest(
            rid=i, ctx=rng.normal(size=(TOY.ctx_len, TOY.ctx_dim)).astype(np.float32),
            noise=rng.normal(size=(TOY.latent_size**2, TOY.in_channels)).astype(np.float32),
            timesteps=4,
        )
        for i in range(3)
    ]
    done, summary = bundle.engine.run(reqs)
    assert sorted(d.rid for d in done) == [0, 1, 2]
    assert summary["full_steps"] == 12 and summary["requests"] == 3
    for d in done:
        assert d.image.shape == (16 * TOY.latent_size**2, 3)
        assert np.isfinite(d.image).all() and np.isfinite(d.latent).all()
