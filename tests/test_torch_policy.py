"""The port's quality policy and shift-score profile against the JAX package's.

numpy only on both sides: every resolution, per-step threshold and bucket
factor must be *equal* (the thresholds are float32 values both packages
compare on the device), not merely close.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.types import PASPlan as JPlan
from repro.core import phase_division as JPD
from repro.core import shift_score as JSS
from repro.serving import policy as JP
from repro_torch.common.types import PASPlan
from repro_torch.core import phase_division as TPD
from repro_torch.core import shift_score as TSS
from repro_torch.serving import policy as TP

N_UP = 9  # sd_toy's and sd_v14's up-step count
QUALITIES = ["draft", "balanced", "high", "exact", 0.0, 0.3, 0.5, 0.7, 1.0, "0.45", None]


def _profile(pkg, seed=0, t=11, blocks=N_UP):
    rng = np.random.default_rng(seed)
    scores = [rng.random((t - 1, blocks)) for _ in range(3)]
    return pkg.build_profile(scores)


def _fields(res) -> dict:
    d = dataclasses.asdict(res)
    d["plan"] = None if res.plan is None else dataclasses.asdict(res.plan)
    return d


def _policies(profile: bool, **kw):
    jprof = tprof = None
    if profile:
        jprof, tprof = _profile(JSS), _profile(TSS)
    return (JP.QualityPolicy(N_UP, profile=jprof, **kw),
            TP.QualityPolicy(N_UP, profile=tprof, **kw))


@pytest.mark.parametrize("quality", QUALITIES, ids=str)
@pytest.mark.parametrize("timesteps", [6, 8, 20, 50])
def test_resolve_matches_jax(quality, timesteps):
    jpol, tpol = _policies(profile=False)
    for pas in (False, True):
        ref = jpol.resolve(timesteps, quality=quality, pas=pas)
        got = tpol.resolve(timesteps, quality=quality, pas=pas)
        assert _fields(got) == _fields(ref)


@pytest.mark.parametrize("quality", ["draft", 0.3, "high", None])
def test_resolve_explicit_plan_and_truncated_schedule(quality):
    jpol, tpol = _policies(profile=True, base_threshold=0.2, t_bucket=100)
    plan = dict(t_sketch=3, t_complete=2, t_sparse=2, l_sketch=3, l_refine=2)
    ref = jpol.resolve(6, quality=quality, plan=JPlan(**plan))
    got = tpol.resolve(6, quality=quality, plan=PASPlan(**plan))
    assert _fields(got) == _fields(ref)
    ts = np.arange(6)[::-1][-3:] * 166  # a strength-truncated vector: 3 of 6
    ref, got = jpol.resolve(ts, quality=quality), tpol.resolve(ts, quality=quality)
    assert _fields(got) == _fields(ref)
    assert got.plan is None or got.plan == PASPlan(**dataclasses.asdict(ref.plan))


def test_exact_with_plan_and_bad_knobs_raise_alike():
    jpol, tpol = _policies(profile=False)
    plan = dict(t_sketch=3, t_complete=2, t_sparse=2, l_sketch=3, l_refine=2)
    for pol, p in ((jpol, JPlan(**plan)), (tpol, PASPlan(**plan))):
        with pytest.raises(ValueError, match="exact cannot carry"):
            pol.resolve(6, quality="exact", plan=p)
        for bad in ("fast", 1.5, -0.1):
            with pytest.raises(ValueError, match="quality must be"):
                pol.resolve(6, quality=bad)
        with pytest.raises(ValueError, match="1-D and nonempty"):
            pol.resolve(np.zeros((0,), np.int64), quality="draft")


@pytest.mark.parametrize("profile", [False, True], ids=["scalar", "profile"])
@pytest.mark.parametrize("quality", ["draft", "balanced", 0.7, "exact", None])
def test_threshold_spec_matches_jax(profile, quality):
    jpol, tpol = _policies(profile=profile, base_threshold=0.15, t_bucket=125)
    ts = np.asarray([999, 833, 666, 500, 333, 166, 0, 124, 125, 126])
    for default in (0.15, 0.0, 0.3):
        ref = jpol.resolve(10, quality=quality).threshold_spec(default)
        got = tpol.resolve(10, quality=quality).threshold_spec(default)
        if callable(ref):
            r, g = ref(ts), got(ts)
            assert g.dtype == np.float32 and np.array_equal(g, r)
        else:
            assert not callable(got) and got == ref


def test_thresholds_are_float32_rounded_as_jax_rounds_them():
    for base in (0.15, 0.1, 0.2, 1 / 3):
        jpol, tpol = _policies(profile=False, base_threshold=base)
        for q in (0.0, 0.1, 0.25, 0.3, 0.55, 0.9):
            got = tpol.resolve(6, quality=q).cache_threshold
            assert got == jpol.resolve(6, quality=q).cache_threshold
            assert got == float(np.float32(got))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("t_bucket", [100, 125, 333])
def test_profile_bucket_factors_match_jax(seed, t_bucket):
    jprof, tprof = _profile(JSS, seed), _profile(TSS, seed)
    assert tprof.outlier_blocks == jprof.outlier_blocks
    np.testing.assert_array_equal(tprof.scores, jprof.scores)
    np.testing.assert_array_equal(
        TPD.mean_score_excluding_outliers(tprof), JPD.mean_score_excluding_outliers(jprof)
    )
    for ts in (None, np.arange(11)[::-1] * 90):
        ref = JP.profile_bucket_factors(jprof, ts, t_bucket=t_bucket)
        got = TP.profile_bucket_factors(tprof, ts, t_bucket=t_bucket)
        assert got == ref


def test_profile_round_trip_and_cross_package_files(tmp_path):
    tprof = _profile(TSS, 5)
    ts = np.arange(11)[::-1] * 90
    TSS.save_profile(str(tmp_path / "t.npz"), tprof, ts)
    back, back_ts = TSS.load_profile(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.scores, np.asarray(tprof.scores, np.float32))
    assert back.outlier_blocks == tprof.outlier_blocks
    np.testing.assert_array_equal(back_ts, ts)
    # the two packages read each other's files
    jback, jts = JSS.load_profile(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(jback.scores, back.scores)
    JSS.save_profile(str(tmp_path / "j.npz"), jback)
    tback, tts = TP.load_policy_profile(str(tmp_path / "j.npz"))
    assert tts is None and tback.outlier_blocks == jback.outlier_blocks


def test_tier_helpers_and_default_plan_match_jax():
    for q in np.linspace(0, 1, 21):
        assert TP.tier_of_quality(float(q)) == JP.tier_of_quality(float(q))
    for v in ("draft", " High ", "0.4", 0.9):
        assert TP.parse_quality(v) == JP.parse_quality(v)
    assert TP.TIER_QUALITY == JP.TIER_QUALITY
    for t in (1, 2, 5, 8, 20, 50):
        assert dataclasses.asdict(TP.default_pas_plan(t, N_UP)) == dataclasses.asdict(
            JP.default_pas_plan(t, N_UP)
        )
    assert TSS.paper_block_to_up_step(N_UP, 1) == JSS.paper_block_to_up_step(N_UP, 1)
    assert TSS.up_step_to_paper_block(N_UP, 4) == JSS.up_step_to_paper_block(N_UP, 4)
