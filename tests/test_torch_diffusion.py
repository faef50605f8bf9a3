"""Parity of repro_torch.models.diffusion against repro.models.diffusion.

Same inputs, made from a seed with numpy, through both packages, in
float32.  Tolerance 1e-6, absolute on the schedule and single steps and
relative to max(1, max |x|) over multistep PNDM trajectories, which grow
to |x| ~ 44 (measured: schedule and single steps 7e-7, trajectories 3.1e-5
against a bound of 4.5e-5).  The CFG combination, whose guidance 7.5
amplifies matmul rounding, is held at 1e-5 (measured 1.9e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.models import diffusion as JD
from repro_torch.common.types import DiffusionConfig
from repro_torch.models import diffusion as TD

ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the CPU, and torch's
    spinning thread pool slows a crowded worker many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear"])
def test_schedule_and_timesteps(schedule):
    jcfg = JDiffusionConfig(timesteps_sample=8, beta_schedule=schedule)
    tcfg = DiffusionConfig(timesteps_sample=8, beta_schedule=schedule)
    js, ts = JD.make_schedule(jcfg), TD.make_schedule(tcfg)
    np.testing.assert_allclose(ts.betas.numpy(), np.asarray(js.betas), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod), atol=ATOL, rtol=0
    )
    np.testing.assert_array_equal(
        TD.sample_timesteps(tcfg).numpy(), np.asarray(JD.sample_timesteps(jcfg))
    )


def _schedules():
    return JD.make_schedule(JDiffusionConfig()), TD.make_schedule(DiffusionConfig())


def test_q_sample():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 16, 4)).astype(np.float32)
    noise = rng.normal(size=(3, 16, 4)).astype(np.float32)
    t = np.array([0, 500, 999], np.int32)
    js, ts = _schedules()
    ref = JD.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = TD.q_sample(ts, _t(x0), _t(t).long(), _t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_ddim_step_batched():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 4)).astype(np.float32)
    eps = rng.normal(size=(3, 16, 4)).astype(np.float32)
    t = np.array([980, 500, 20], np.int32)
    tp = np.array([960, 480, -1], np.int32)
    js, ts = _schedules()
    ref = JD.ddim_step_batched(
        js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t), jnp.asarray(tp)
    )
    got = TD.ddim_step_batched(ts, _t(x), _t(eps), _t(t).long(), _t(tp).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_pndm_step_batched_mixed_warmup():
    """Several steps with lanes at warmup counts 0..3: every PLMS order runs."""
    rng = np.random.default_rng(2)
    b, shape = 4, (16, 4)
    x = rng.normal(size=(b,) + shape).astype(np.float32)
    ets = rng.normal(size=(b, 4) + shape).astype(np.float32)
    n_ets = np.array([0, 1, 2, 3], np.int32)
    js, ts = _schedules()
    jx, jets, jn = jnp.asarray(x), jnp.asarray(ets), jnp.asarray(n_ets)
    tx, tets, tn = _t(x), _t(ets), _t(n_ets).long()
    for step, t0 in enumerate([900, 700, 500, 300, 100]):
        eps = rng.normal(size=(b,) + shape).astype(np.float32)
        t = np.full((b,), t0, np.int32) - np.arange(b, dtype=np.int32)
        tp = np.where(t0 == 100, -1, t - 200).astype(np.int32)
        jx, jets, jn = JD.pndm_step_batched(
            js, jets, jn, jx, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(tp)
        )
        tx, tets, tn = TD.pndm_step_batched(ts, tets, tn, tx, _t(eps), _t(t).long(), _t(tp).long())
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=f"step {step}")
        np.testing.assert_allclose(tets.numpy(), np.asarray(jets), atol=ATOL, rtol=0)
        scale = max(1.0, float(np.abs(np.asarray(jx)).max()))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL * scale, rtol=0)


def test_pndm_step_scalar_and_cfg_eps():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 4)).astype(np.float32)
    js, ts = _schedules()
    jstate, tstate = JD.pndm_init(x.shape, jnp.float32), TD.pndm_init(x.shape)
    jx, tx = jnp.asarray(x), _t(x)
    for t, tp in [(750, 500), (500, 250), (250, 0), (0, -1)]:
        eps = rng.normal(size=x.shape).astype(np.float32)
        jx, jstate = JD.pndm_step(js, jstate, jx, jnp.asarray(eps), jnp.int32(t), jnp.int32(tp))
        tx, tstate = TD.pndm_step(ts, tstate, tx, _t(eps), t, tp)
        scale = max(1.0, float(np.abs(np.asarray(jx)).max()))
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL * scale, rtol=0)
    assert tstate.n_ets == int(jstate.n_ets)

    w = rng.normal(size=(4, 4)).astype(np.float32)
    cond = rng.normal(size=(2, 3, 4)).astype(np.float32)
    unc = np.zeros_like(cond)
    jfn = lambda x2, t2, c2: x2 @ jnp.asarray(w) + c2.mean(axis=1, keepdims=True)  # noqa: E731
    tfn = lambda x2, t2, c2: x2 @ _t(w) + c2.mean(dim=1, keepdim=True)  # noqa: E731
    tt = np.array([5, 5], np.int32)
    ref = JD.cfg_eps(jfn, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(cond), jnp.asarray(unc), 7.5)
    got = TD.cfg_eps(tfn, _t(x), _t(tt), _t(cond), _t(unc), 7.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
