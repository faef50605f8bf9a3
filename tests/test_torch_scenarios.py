"""The port's conditioned scenarios, straight-line sampler, static server and
serve CLI against the JAX package, live.

The stream is ``scenario_requests()`` (img2img at strengths 0.4 and 0.75,
inpaint with a full-ones and a half mask, a K=3 variation group) on sd_toy,
weights from ``repro``'s ``init_unet(jax.random.key(0))`` through
``repro_torch.bridge``.  Tolerances are the JAX package's own: 5e-4 for an
engine, 2e-4 for the straight-line sampler (measured: 6.3e-5 and 6.5e-5 on
latents of up to 24.7).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import sampler as JSM
from repro.models import unet as JU
from repro.serving import scenarios as JSC
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.core import sampler as TSM
from repro_torch.launch import serve as SERVE
from repro_torch.serving import scenarios as TSC
from repro_torch.serving.engine import GenRequest, StaticServer

ENGINE_TOL, LINE_TOL = 5e-4, 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jparams = jax.jit(JU.init_unet, static_argnums=1)(jax.random.key(0), JSC.UCFG)
    return jparams, bridge.unet_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.fixture(scope="module")
def jax_engine(weights):
    return JSC.run_engine(weights[0])


@pytest.fixture(scope="module")
def jax_line(weights):
    return JSC.run_straight_line(weights[0])


@pytest.fixture(scope="module")
def port_engine(weights):
    return TSC.run_engine(weights[1], device="cpu")


@pytest.fixture(scope="module")
def port_line(weights):
    return TSC.run_straight_line(weights[1], device="cpu")


def test_constants_match_jax():
    assert TSC.UCFG == dataclasses.replace(TSC.UCFG, **dataclasses.asdict(JSC.UCFG))
    assert dataclasses.asdict(TSC.DCFG) == dataclasses.asdict(JSC.DCFG)
    assert (TSC.N_LANES, TSC.MAX_STEPS, TSC.L_SKETCH, TSC.L_REFINE, TSC._REQ_SEED) == (
        JSC.N_LANES, JSC.MAX_STEPS, JSC.L_SKETCH, JSC.L_REFINE, JSC._REQ_SEED)


@pytest.mark.parametrize("i", range(7))
def test_scenario_requests_equal_jax(i):
    (jname, jreq), (tname, treq) = JSC.scenario_requests()[i], TSC.scenario_requests()[i]
    assert tname == jname and treq.rid == jreq.rid
    for f in ("ctx", "noise", "init_latent", "mask"):
        a, b = getattr(treq, f), getattr(jreq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (treq.timesteps, treq.base_timesteps) == (jreq.timesteps, jreq.base_timesteps)
    assert (treq.plan is None) == (jreq.plan is None)
    if treq.plan is not None:
        assert dataclasses.asdict(treq.plan) == dataclasses.asdict(jreq.plan)


def test_truncated_timesteps_match_jax():
    for base, n in ((6, 2), (6, 5), (6, 6), (50, 37), (8, 1)):
        got = TSC.SM.truncated_timesteps(TSC.DCFG, base, n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JSM.truncated_timesteps(JSC.DCFG, base, n)))
    with pytest.raises(ValueError):
        TSM.truncated_timesteps(TSC.DCFG, 6, 7)


def test_run_engine_matches_jax(jax_engine, port_engine):
    assert sorted(port_engine) == sorted(jax_engine)
    for name in jax_engine:
        np.testing.assert_allclose(
            port_engine[name], jax_engine[name], atol=ENGINE_TOL, rtol=0, err_msg=name)


def test_run_straight_line_matches_jax(jax_line, port_line):
    assert sorted(port_line) == sorted(jax_line)
    for name in jax_line:
        np.testing.assert_allclose(
            port_line[name], jax_line[name], atol=LINE_TOL, rtol=0, err_msg=name)


def test_port_engine_tracks_its_straight_line(port_engine, port_line):
    for name in port_line:
        np.testing.assert_allclose(
            port_engine[name], port_line[name], atol=ENGINE_TOL, rtol=0, err_msg=name)


def test_inpaint_keeps_the_known_region(port_line):
    """After the last step the kept half of ``inpaint_half`` is the init
    latent itself (re-noised to t = -1, i.e. clean)."""
    req = dict(TSC.scenario_requests())["inpaint_half"]
    keep = req.mask[:, 0] == 0
    np.testing.assert_array_equal(port_line["inpaint_half"][keep], req.init_latent[keep])


def test_engine_threshold_zero_cache_is_bitwise_cache_off(weights, port_engine):
    got = TSC.run_engine(weights[1], cache_mode="cross", cache_threshold=0.0, device="cpu")
    for name in port_engine:
        assert torch.equal(torch.from_numpy(got[name]), torch.from_numpy(port_engine[name])), name


def test_static_server_matches_pas_denoise(weights):
    """Two all-FULL requests in one lockstep batch against ``pas_denoise``."""
    ucfg, dcfg = TSC.UCFG, TSC.DCFG
    reqs = [r for _, r in TSC.scenario_requests()][-2:]
    reqs = [GenRequest(rid=i, ctx=r.ctx, noise=r.noise, timesteps=6) for i, r in enumerate(reqs)]
    server = StaticServer(ucfg, dcfg, weights[1], None, 2, device="cpu")
    server.warmup([6])
    assert server.time_step_s(6, iters=1) > 0
    done, summary = server.run(reqs)
    assert summary["mode"] == "static" and summary["idle_lane_frac"] == 0.0
    ref = TSM.pas_denoise(
        ucfg, dcfg, weights[1], None,
        torch.from_numpy(np.stack([r.noise for r in reqs])),
        torch.from_numpy(np.stack([r.ctx for r in reqs])),
        torch.zeros((2, ucfg.ctx_len, ucfg.ctx_dim)),
    )
    for d in done:
        np.testing.assert_allclose(d.latent, ref[d.rid].numpy(), atol=LINE_TOL, rtol=0)


def test_static_server_pads_and_reports_idle(weights):
    reqs = [GenRequest(rid=i, ctx=r.ctx, noise=r.noise, timesteps=t) for i, ((_, r), t) in
            enumerate(zip(TSC.scenario_requests()[:3], (4, 2, 3)))]
    plan_fn = lambda t: None if t < 4 else PASPlan(3, 2, 2, 3, 2)  # noqa: E731
    server = StaticServer(TSC.UCFG, DiffusionConfig(), weights[1], None, 2,
                          plan_fn=plan_fn, device="cpu")
    done, summary = server.run(reqs)
    assert sorted(d.rid for d in done) == [0, 1, 2]
    # batch 1 runs 4 steps for 4 + 2 useful, batch 2 runs 3 for 3 (one pad lane)
    assert summary["idle_lane_frac"] == round(1 - 9 / 14, 3)


def _cli_args(**kw):
    base = dict(mode="diffusion", unet="sd_toy", requests=2, batch=2, timesteps=4, pas=False,
                quality=None, profile=None, engine="continuous", window=4, kernels=None,
                device="cpu", cache="off", cache_threshold=0.15, cache_slots=16,
                cache_bucket=125, cache_spill_mb=0.0, seed=0)
    return types.SimpleNamespace(**dict(base, **kw))


@pytest.mark.parametrize(
    "kw", [dict(cache="cross", quality="draft"), dict(engine="static", pas=True)],
    ids=["cross-draft", "static"],
)
def test_serve_cli_runs_in_process(kw):
    out = SERVE.serve_diffusion(_cli_args(**kw))
    assert out["requests"] == 2 and out["engine"] == kw.get("engine", "continuous")
    assert out["image_shape"] == (16 * TSC.UCFG.latent_size**2, 3)
    if kw.get("cache") == "cross":
        assert out["cache_mode"] == "cross" and out["quality_mix"] == {"draft": 2}
    else:
        assert out["idle_lane_frac"] == 0.0


def test_serve_cli_parses_the_new_flags(capsys):
    SERVE.main(["--device", "cpu", "--requests", "1", "--batch", "1", "--timesteps", "4",
                "--cache", "intra", "--cache-threshold", "0.3", "--cache-slots", "2",
                "--cache-bucket", "1000", "--cache-spill-mb", "1", "--quality", "0.3"])
    out = capsys.readouterr().out
    assert "'cache_mode': 'intra'" in out and "'cache_slots': 2" in out
    assert "'cache_spill_capacity_bytes': 1048576" in out
    with pytest.raises(SystemExit):
        SERVE.serve_diffusion(_cli_args(engine="static", cache="cross"))
