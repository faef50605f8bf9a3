"""Phase division (paper Eq. 2): 2-means sweep over the transition timestep.

    D* = argmin_D  sum_{t<=D} (S_t - mu_sketch)^2 + sum_{t>D} (S_t - mu_refine)^2

computed on the block-averaged shift score with outlier curves excluded
(they belong to the refinement phase by construction).  The port's own copy
of ``repro/core/phase_division.py``, in the same float64 numpy arithmetic,
so that near ties break the same way.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.shift_score import ShiftProfile


def mean_score_excluding_outliers(profile: ShiftProfile) -> np.ndarray:
    mask = np.ones(profile.n_blocks, bool)
    for b in profile.outlier_blocks:
        if len(profile.outlier_blocks) < profile.n_blocks:  # keep >=1 block
            mask[b - 1] = False
    return profile.scores[:, mask].mean(axis=1)


def transition_costs(profile: ShiftProfile) -> np.ndarray:
    """Eq. 2's cost of each split D = 1 .. T-2 (entry D-1)."""
    s = mean_score_excluding_outliers(profile)
    costs = []
    for d in range(1, s.shape[0] - 1):  # paper: D = 1 .. T-2
        mu_skt = s[: d + 1].mean()
        mu_ref = s[d + 1 :].mean()
        costs.append(((s[: d + 1] - mu_skt) ** 2).sum() + ((s[d + 1 :] - mu_ref) ** 2).sum())
    return np.asarray(costs, np.float64)


def find_transition(profile: ShiftProfile) -> int:
    """Returns D* as a timestep index into the sampling schedule: the first
    split of least cost (a strict ``<``, as the reference sweeps)."""
    best_d, best_cost = 1, np.inf
    for d, cost in enumerate(transition_costs(profile), start=1):
        if cost < best_cost:
            best_cost, best_d = cost, d
    return best_d


def phase_stats(profile: ShiftProfile, d_star: int) -> dict:
    s = mean_score_excluding_outliers(profile)
    return {
        "d_star": d_star,
        "mu_sketch": float(s[: d_star + 1].mean()),
        "mu_refine": float(s[d_star + 1 :].mean()),
        "outlier_blocks": profile.outlier_blocks,
    }
