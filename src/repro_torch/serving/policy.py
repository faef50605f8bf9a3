"""The serving stack's stock phase-aware plan.

The port's own copy of ``repro/serving/policy.py::default_pas_plan``; the
per-request ``QualityPolicy`` is not ported yet.
"""
from __future__ import annotations

from repro_torch.common.types import PASPlan


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
