"""Per-request quality policy: one resolver from quality knob to plan + threshold.

The port's own copy of ``repro/serving/policy.py``.  The paper's phase-aware
sampling "balances image quality and complexity based on ... user
requirements", so the trade is a per-request decision:

* a **named tier** (``draft`` | ``balanced`` | ``high`` | ``exact``) or a
  **continuous** ``quality`` in ``[0, 1]`` maps to a
  :class:`~repro_torch.common.types.PASPlan` shape plus a cache-threshold
  scale: lower quality means an earlier sketch transition, sparser FULL
  refreshes and a looser feature-reuse threshold;
* ``exact`` (``quality == 1``) resolves to the all-FULL plan and threshold
  ``0.0``, bit-exact with the cache off by the cache's strict-inequality
  hit rule;
* an optional **shift-score calibration profile**
  (:class:`~repro_torch.core.shift_score.ShiftProfile`) refines the scalar
  threshold into per-timestep-bucket thresholds.

The resolution rides on the request (``GenRequest.policy``) down to the
micro-step: the engine stores a per-lane, per-step float32 threshold leaf
in the lane state and the device compares the probed slot's distance
against it.  Thresholds are rounded to float32 here exactly as the JAX
package rounds them, because both packages compare them on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.common.types import PASPlan
from repro_torch.core.phase_division import mean_score_excluding_outliers
from repro_torch.core.shift_score import ShiftProfile, load_profile

#: tier name -> continuous quality setting
TIER_QUALITY: dict[str, float] = {
    "draft": 0.25,
    "balanced": 0.5,
    "high": 0.75,
    "exact": 1.0,
}

#: quality below these bounds selects the matching plan shape
_TIER_EDGES = ((0.375, "draft"), (0.625, "balanced"), (1.0, "high"))

#: clamp range for profile-derived per-bucket threshold factors
_FACTOR_LO, _FACTOR_HI = 0.25, 1.5


def default_pas_plan(
    timesteps: int, n_up: int, l_sketch: int | None = None, l_refine: int | None = None
) -> PASPlan:
    """The ``balanced`` tier's plan shape, valid down to ``timesteps=1``;
    ``l_sketch``/``l_refine`` default to the engine-standard ``min(3, n_up)``
    / ``min(2, n_up)`` cache geometry."""
    t_sketch = max(1, timesteps // 2)
    plan = PASPlan(
        t_sketch=t_sketch,
        t_complete=min(t_sketch, max(2, timesteps // 10)),
        t_sparse=4,
        l_sketch=min(3, n_up) if l_sketch is None else l_sketch,
        l_refine=min(2, n_up) if l_refine is None else l_refine,
    )
    plan.validate(timesteps, n_up)
    return plan


def tier_of_quality(quality: float) -> str:
    """Nearest named tier for a continuous quality setting."""
    for edge, tier in _TIER_EDGES:
        if quality < edge:
            return tier
    return "exact"


def parse_quality(value) -> float:
    """Normalize a payload/CLI quality knob (tier name or number) to [0, 1]."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in TIER_QUALITY:
            return TIER_QUALITY[v]
        try:
            value = float(v)
        except ValueError:
            raise ValueError(
                f"quality must be one of {sorted(TIER_QUALITY)} or a number in "
                f"[0, 1], got {value!r}"
            ) from None
    q = float(value)
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quality must be in [0, 1], got {q}")
    return q


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """Concrete per-request quality decision: plan + cache thresholds.

    ``cache_threshold is None`` means "use the engine default" (requests
    that carry no quality knob).  With a calibration profile attached,
    ``bucket_factors`` scales the scalar threshold per train-timestep bucket
    of width ``t_bucket``.
    """

    tier: str
    quality: float | None
    plan: PASPlan | None
    cache_threshold: float | None
    #: per-bucket multipliers on the scalar threshold (index = t // t_bucket)
    bucket_factors: tuple[float, ...] | None = None
    t_bucket: int = 125
    #: opt-in to serving planned SKETCH steps as REFINE from warm cache slots
    refine_demotions: bool = False

    def threshold_for(self, t: int, default: float) -> float:
        """Cache threshold at train timestep ``t`` (float32 exact)."""
        base = default if self.cache_threshold is None else self.cache_threshold
        if self.bucket_factors is not None and base > 0.0:
            base *= self.bucket_factors[
                min(int(t) // self.t_bucket, len(self.bucket_factors) - 1)
            ]
        return float(np.float32(base))

    def threshold_spec(self, default: float) -> float | Callable[[np.ndarray], np.ndarray]:
        """Per-step threshold source for ``lanes.make_plan_arrays``."""
        if self.cache_threshold is None and self.bucket_factors is None:
            return default
        return lambda ts: np.asarray(
            [self.threshold_for(int(t), default) for t in ts], np.float32
        )


def legacy_policy(plan: PASPlan | None) -> ResolvedPolicy:
    """The resolution of a request without a quality knob: its plan (or the
    stock PAS plan under ``pas``) and the engine-global threshold."""
    return ResolvedPolicy(
        tier="pas" if plan is not None else "full",
        quality=None,
        plan=plan,
        cache_threshold=None,
    )


class QualityPolicy:
    """Resolver from a per-request quality knob to a :class:`ResolvedPolicy`,
    one per serving process, built from the engine's cache geometry plus an
    optional shift-score calibration profile."""

    def __init__(
        self,
        n_up: int,
        *,
        l_sketch: int | None = None,
        l_refine: int | None = None,
        base_threshold: float = 0.15,
        t_bucket: int = 125,
        t_train: int = 1000,
        profile: ShiftProfile | None = None,
        profile_ts: np.ndarray | None = None,
    ):
        self.n_up = n_up
        self.l_sketch = min(3, n_up) if l_sketch is None else l_sketch
        self.l_refine = min(2, n_up) if l_refine is None else l_refine
        self.base_threshold = base_threshold
        self.t_bucket = t_bucket
        self.t_train = t_train
        self.bucket_factors: tuple[float, ...] | None = None
        if profile is not None:
            self.bucket_factors = profile_bucket_factors(
                profile, profile_ts, t_train=t_train, t_bucket=t_bucket
            )

    @classmethod
    def for_engine(cls, ucfg, dcfg, engine_config, **kw) -> "QualityPolicy":
        """Build from the served model/engine configs (the usual path)."""
        from repro_torch.models import unet as U

        return cls(
            U.n_up_steps(ucfg),
            l_sketch=engine_config.l_sketch,
            l_refine=engine_config.l_refine,
            base_threshold=engine_config.cache_threshold,
            t_bucket=engine_config.cache_t_bucket,
            t_train=dcfg.timesteps_train,
            **kw,
        )

    def _tier_plan(self, tier: str, timesteps: int) -> PASPlan | None:
        """Tier plan shapes, ordered by planned FULL-step count:
        draft < balanced < high < exact (= all FULL)."""
        if tier == "exact":
            return None
        if tier == "draft":  # earliest transition, sparsest FULL refreshes
            t_sketch = max(1, timesteps // 3)
            plan = PASPlan(
                t_sketch=t_sketch,
                t_complete=min(t_sketch, max(1, timesteps // 12)),
                t_sparse=6,
                l_sketch=self.l_sketch,
                l_refine=self.l_refine,
            )
        elif tier == "high":  # late transition, dense FULL refreshes
            t_sketch = max(1, (3 * timesteps) // 4)
            plan = PASPlan(
                t_sketch=t_sketch,
                t_complete=min(t_sketch, max(2, timesteps // 4)),
                t_sparse=2,
                l_sketch=self.l_sketch,
                l_refine=self.l_refine,
            )
        else:  # balanced: the stock serving plan
            return default_pas_plan(timesteps, self.n_up, self.l_sketch, self.l_refine)
        plan.validate(timesteps, self.n_up)
        return plan

    def resolve(
        self,
        timesteps: int | np.ndarray,
        *,
        quality: float | str | None = None,
        pas: bool = False,
        plan: PASPlan | None = None,
    ) -> ResolvedPolicy:
        """Resolve one request's quality decision.

        ``timesteps`` is the executed step count or the request's actual
        train-timestep vector (a truncated img2img schedule); plan shapes are
        sized to the executed length either way.  ``quality=None`` keeps the
        request's ``plan`` (or the stock PAS plan under ``pas``) and the
        engine-global threshold.  With a quality knob the tier decides the
        plan shape (unless ``plan`` overrides it) and the threshold scale;
        ``exact`` is the bit-exact all-FULL resolution.
        """
        if not isinstance(timesteps, (int, np.integer)):
            ts = np.asarray(timesteps)
            if ts.ndim != 1 or ts.size == 0:
                raise ValueError(
                    f"timestep vector must be 1-D and nonempty, got shape {ts.shape}"
                )
            timesteps = int(ts.size)
        if quality is None:
            if plan is None and pas:
                plan = default_pas_plan(timesteps, self.n_up, self.l_sketch, self.l_refine)
            return legacy_policy(plan)
        q = parse_quality(quality)
        tier = tier_of_quality(q)
        if plan is None:
            plan = self._tier_plan(tier, timesteps)
        elif tier == "exact":
            raise ValueError("quality=exact cannot carry a PAS plan (it is all-FULL)")
        # threshold scale: 2x base at q=0, 1x at balanced, 0 exactly at q=1
        threshold = 0.0 if q >= 1.0 else float(np.float32(self.base_threshold * 2.0 * (1.0 - q)))
        return ResolvedPolicy(
            tier=tier,
            quality=q,
            plan=plan,
            cache_threshold=threshold,
            bucket_factors=None if threshold == 0.0 else self.bucket_factors,
            t_bucket=self.t_bucket,
            # deeper cuts only below the 'high' tier
            refine_demotions=q < 0.625,
        )


def profile_bucket_factors(
    profile: ShiftProfile,
    profile_ts: np.ndarray | None = None,
    *,
    t_train: int = 1000,
    t_bucket: int = 125,
) -> tuple[float, ...]:
    """Per-timestep-bucket threshold multipliers from a shift-score profile.

    The block-averaged, outlier-excluded normalized shift score measures how
    fast the reusable features move at each calibrated step: a low-score
    bucket gets a factor above 1 (reuse more), a high-shift bucket one below
    1.  Factors are clamped to [0.25, 1.5]; buckets outside the calibration
    schedule keep 1.0.
    """
    s = mean_score_excluding_outliers(profile)  # [T-1], normalized to ~[0, 1]
    t_steps = s.shape[0] + 1
    if profile_ts is None:
        # assume the calibration sampled the train schedule uniformly
        stride = t_train // t_steps
        profile_ts = (np.arange(t_steps, dtype=np.int64) * stride)[::-1]
    profile_ts = np.asarray(profile_ts, np.int64)
    if profile_ts.shape[0] != t_steps:
        raise ValueError(
            f"profile has {t_steps} calibration steps but ts carries "
            f"{profile_ts.shape[0]} timesteps"
        )
    n_buckets = max(1, math.ceil(t_train / t_bucket))
    sums = np.zeros((n_buckets,), np.float64)
    counts = np.zeros((n_buckets,), np.int64)
    for i in range(s.shape[0]):
        # score row i is the shift arriving at calibration step i+1
        b = min(int(profile_ts[i + 1]) // t_bucket, n_buckets - 1)
        sums[b] += float(s[i])
        counts[b] += 1
    factors = np.ones((n_buckets,), np.float64)
    seen = counts > 0
    factors[seen] = np.clip(1.5 - sums[seen] / counts[seen], _FACTOR_LO, _FACTOR_HI)
    return tuple(float(np.float32(f)) for f in factors)


def load_policy_profile(path: str) -> tuple[ShiftProfile, np.ndarray | None]:
    """Load a calibration profile saved by ``core.shift_score.save_profile``."""
    return load_profile(path)
