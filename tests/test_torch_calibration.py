"""The port's calibration path against the JAX package's, on bridged sd_toy
weights: capture, shift scores (Eq. 1), phase division (Eq. 2), the quality
proxies, and the profile the quality policy serves.

Weights fill ``repro``'s own U-Net tree from a numpy seed (as in
``tests/test_torch_unet.py``) and cross through ``repro_torch.bridge``;
prompts and noise are numpy too.  Each package samples 8 PNDM steps with
every up-step captured, once per module.  Tolerances and the measured
headroom:

* final latent and every captured feature within 2e-4 absolute (measured:
  latent 9.1e-5 on values up to 35.1, features 1.3e-4 on values up to 37.4:
  the 8 guided steps grow both, and the differences with them);
* ``shift_scores`` of both packages on one trajectory within 1e-6 (measured
  3.3e-7 on scores up to 0.73);
* each package's scores from its own trajectory: raw within 1e-4 (measured
  4.8e-7), min-max normalised within 1e-3 (measured 6.6e-7);
* the profile gate: ``profile_bucket_factors`` within 1e-4 (measured
  4.8e-7, one float32 step);
* phase division, outliers and the cosine proxy equal, mse and psnr within
  float32 rounding (1e-6 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.configs import get_unet_config as j_get_unet_config
from repro.core import metrics as JM
from repro.core import phase_division as JPD
from repro.core import sampler as JSM
from repro.core import shift_score as JSS
from repro.models import unet as JU
from repro.serving import policy as JP
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import get_unet_config
from repro_torch.core import metrics as TM
from repro_torch.core import phase_division as TPD
from repro_torch.core import sampler as TSM
from repro_torch.core import shift_score as TSS
from repro_torch.serving import policy as TP
from test_phase_division import synthetic_profile
from test_torch_unet import _numpy_tree

JTOY = j_get_unet_config("sd_toy")
TOY = get_unet_config("sd_toy")
N_UP = JU.n_up_steps(JTOY)
STEPS = 8
ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    """{"jax" | "port": (final latent, trajectory of numpy arrays)}, each once."""
    tree = _numpy_tree(lambda k: JU.init_unet(k, JTOY), seed=0)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, TOY.latent_size**2, TOY.in_channels)).astype(np.float32)
    ctx = (rng.normal(size=(2, TOY.ctx_len, TOY.ctx_dim)) * 0.3).astype(np.float32)
    steps = tuple(range(N_UP))
    jx0, jtraj = JSM.denoise_with_capture(
        JTOY, JDiffusionConfig(timesteps_sample=STEPS),
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(ctx),
        jnp.zeros_like(jnp.asarray(ctx)), capture_steps=steps,
    )
    with torch.no_grad():
        tx0, ttraj = TSM.denoise_with_capture(
            TOY, DiffusionConfig(timesteps_sample=STEPS), bridge.unet_params_from_numpy(tree),
            torch.from_numpy(x), torch.from_numpy(ctx), torch.zeros(ctx.shape),
            capture_steps=steps,
        )
    return {
        "jax": (np.asarray(jx0), [{k: np.array(v) for k, v in c.items()} for c in jtraj]),
        "port": (tx0.numpy(), ttraj),
    }


def test_denoise_with_capture_final_latent_matches_jax(runs):
    (jx0, _), (tx0, _) = runs["jax"], runs["port"]
    assert np.isfinite(tx0).all()
    np.testing.assert_allclose(tx0, jx0, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", range(STEPS))
def test_denoise_with_capture_features_match_jax(runs, t):
    jcap, tcap = runs["jax"][1][t], runs["port"][1][t]
    assert len(runs["port"][1]) == STEPS and sorted(tcap) == sorted(jcap) == list(range(N_UP))
    for s in jcap:
        assert tcap[s].device.type == "cpu" and tcap[s].shape == jcap[s].shape
        np.testing.assert_allclose(tcap[s].numpy(), jcap[s], atol=ATOL, rtol=0, err_msg=f"step {s}")


def test_captures_are_copies(runs):
    """Every capture owns its storage: none is a view of another step's
    tensor or of the U-Net's activations, which later calls may overwrite."""
    ptrs = [v.untyped_storage().data_ptr() for cap in runs["port"][1] for v in cap.values()]
    assert len(set(ptrs)) == len(ptrs) == STEPS * N_UP


def test_shift_scores_on_one_trajectory_match_jax(runs):
    traj = runs["jax"][1]
    want = JSS.shift_scores(traj)
    got = TSS.shift_scores(traj)
    assert got.shape == want.shape == (STEPS - 1, N_UP)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # tensors and arrays score alike
    as_tensors = [{k: torch.from_numpy(v) for k, v in c.items()} for c in traj]
    np.testing.assert_array_equal(TSS.shift_scores(as_tensors), got)


def test_shift_scores_each_from_its_own_trajectory(runs):
    want, got = JSS.shift_scores(runs["jax"][1]), TSS.shift_scores(runs["port"][1])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        TSS.minmax_normalize(got), JSS.minmax_normalize(want), atol=1e-3, rtol=0
    )


def test_profile_gate_bucket_factors_match_jax(runs, tmp_path):
    """The ROADMAP gate: the port's profile drives the quality policy to the
    bucket factors of ``repro``'s profile on the same weights, and a profile
    saved by either package loads equal in the other."""
    jprof = JSS.build_profile([JSS.shift_scores(runs["jax"][1])])
    tprof = TSS.build_profile([TSS.shift_scores(runs["port"][1])])
    assert tprof.outlier_blocks == jprof.outlier_blocks
    ts = np.arange(STEPS)[::-1] * (1000 // STEPS)
    for t_bucket in (125, 250):
        want = JP.profile_bucket_factors(jprof, ts, t_bucket=t_bucket)
        got = TP.profile_bucket_factors(tprof, ts, t_bucket=t_bucket)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for save, load, prof in ((TSS.save_profile, JSS.load_profile, tprof),
                             (JSS.save_profile, TSS.load_profile, jprof)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, prof, ts=ts)
        back, back_ts = load(path)
        np.testing.assert_array_equal(back.scores, prof.scores.astype(np.float32))
        assert back.outlier_blocks == prof.outlier_blocks
        np.testing.assert_array_equal(back_ts, ts)


@pytest.mark.parametrize("outliers", [(1, 2), (), (12,)], ids=str)
@pytest.mark.parametrize("seed", [0, 5, 13])
@pytest.mark.parametrize("d_true", [8, 24, 40])
def test_phase_division_matches_jax(d_true, seed, outliers):
    """``find_transition``, ``detect_outliers`` and ``phase_stats`` on the
    reference test's synthetic profiles: equal, not close."""
    scores = synthetic_profile(t=49, d_true=d_true, seed=seed, outliers=outliers)
    assert TSS.detect_outliers(scores) == JSS.detect_outliers(scores)
    jprof = JSS.ShiftProfile(scores=scores, outlier_blocks=JSS.detect_outliers(scores))
    tprof = TSS.ShiftProfile(scores=scores, outlier_blocks=TSS.detect_outliers(scores))
    d = TPD.find_transition(tprof)
    assert d == JPD.find_transition(jprof)
    assert TPD.phase_stats(tprof, d) == JPD.phase_stats(jprof, d)


def test_find_transition_breaks_ties_as_jax():
    """A flat profile gives every split cost 0 and 1, 1, 0, 0, 1, 1 gives
    D = 1 and D = 3 cost 1.0 exactly; the strict ``<`` keeps the first, as
    the reference does."""
    flat, two = np.full((9, 4), 0.5), np.tile([[1.0], [1.0], [0.0], [0.0], [1.0], [1.0]], (1, 3))
    for scores, tied in ((flat, (0, 6)), (two, (0, 2))):
        prof = TSS.ShiftProfile(scores=scores, outlier_blocks=())
        costs = TPD.transition_costs(prof)
        assert costs[tied[0]] == costs[tied[1]] == costs.min()
        assert TPD.find_transition(prof) == 1 == JPD.find_transition(
            JSS.ShiftProfile(scores=scores, outlier_blocks=()))


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 64, 4)).astype(np.float32) * 3
    b = a + rng.normal(size=a.shape).astype(np.float32) * 0.1
    for x, y in ((a, b), (b, a), (a, a)):
        np.testing.assert_allclose(TM.latent_mse(x, y), JM.latent_mse(x, y), rtol=1e-6, atol=0)
        np.testing.assert_allclose(TM.latent_psnr(x, y), JM.latent_psnr(x, y), rtol=1e-6)
        assert TM.latent_cosine(x, y) == JM.latent_cosine(x, y)
        assert TM.latent_cosine(torch.from_numpy(x), y) == JM.latent_cosine(x, y)
