"""Phase division (paper Eq. 2): the score the quality policy reads.

The port's own copy of ``mean_score_excluding_outliers`` from
``repro/core/phase_division.py``: the block-averaged shift score with the
outlier blocks left out.  The 2-means sweep over the transition timestep
(``find_transition``) comes with the calibration pipeline.
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
