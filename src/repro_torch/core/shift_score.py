"""Shift-score analysis (paper Eq. 1, Fig. 4).

    S_t^i = || A_t^i - A_{t-1}^i ||_2 / || A_{t-1}^i ||_2

where ``A_t^i`` is the main-branch input activation of the i-th upsampling
block at denoising timestep t, as ``repro_torch.core.sampler.
denoise_with_capture`` captures it.  The port's own copy of
``repro/core/shift_score.py``: the scores in float32 torch on the device
that holds the trajectory, then paper/executor block indexing, min-max
normalisation, outlier detection and the ``.npz`` profile format the
quality policy reads, on the host in numpy.

Paper indexing: block 1 is the *topmost* (highest-resolution) upsampling
block; the U-Net executes up-steps deepest first, so paper block i is
up-step ``n_up - i``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def paper_block_to_up_step(n_up: int, block: int) -> int:
    """Paper block index (1 = topmost) -> executor up-step index."""
    assert 1 <= block <= n_up
    return n_up - block


def up_step_to_paper_block(n_up: int, step: int) -> int:
    return n_up - step


def shift_scores(traj: Sequence[dict[int, torch.Tensor]]) -> np.ndarray:
    """traj[t][step] = captured activation at timestep t (a tensor, or an
    array, which is read on the CPU).

    Returns scores [T-1, n_blocks] in *paper block order* (block 1 first).
    """
    steps = sorted(traj[0].keys())
    out = np.zeros((len(traj) - 1, len(steps)))
    for ti in range(1, len(traj)):
        for si, s in enumerate(steps):
            prev = torch.as_tensor(traj[ti - 1][s], dtype=torch.float32)
            cur = torch.as_tensor(traj[ti][s], dtype=torch.float32)
            denom = torch.linalg.vector_norm(prev) + 1e-12
            out[ti - 1, si] = float(torch.linalg.vector_norm(cur - prev) / denom)
    # captured steps ascend (deep->top); paper blocks descend resolution,
    # block 1 = last executed step -> reverse the column order
    return out[:, ::-1]


def minmax_normalize(scores: np.ndarray) -> np.ndarray:
    """Per-block min-max scaling to [0, 1] (paper's normalization)."""
    lo = scores.min(axis=0, keepdims=True)
    hi = scores.max(axis=0, keepdims=True)
    return (scores - lo) / np.maximum(hi - lo, 1e-12)


@dataclasses.dataclass(frozen=True)
class ShiftProfile:
    """Aggregated shift-score statistics over a calibration set."""

    scores: np.ndarray  # [T-1, n_blocks], min-max normalized, image-averaged
    outlier_blocks: tuple[int, ...]  # paper block indices (1-based)

    @property
    def n_blocks(self) -> int:
        return self.scores.shape[1]


def late_scores(
    scores: np.ndarray, late_frac: float = 0.25, z: float = 1.0
) -> tuple[np.ndarray, float]:
    """(each block's mean score over the last ``late_frac`` of timesteps,
    the outlier threshold mean + z*std of those means)."""
    t = scores.shape[0]
    per_block = scores[int((1 - late_frac) * t):].mean(axis=0)
    return per_block, per_block.mean() + z * per_block.std()


def detect_outliers(scores: np.ndarray, late_frac: float = 0.25, z: float = 1.0) -> tuple[int, ...]:
    """Blocks whose shift score stays high in the late (refinement) phase:
    a late mean above the threshold of :func:`late_scores` (the paper's Key
    Observation 2)."""
    per_block, thresh = late_scores(scores, late_frac, z)
    return tuple(int(i) + 1 for i in np.nonzero(per_block > thresh)[0])


def build_profile(all_scores: Sequence[np.ndarray]) -> ShiftProfile:
    """Average per-image score curves, normalize, detect outliers."""
    avg = np.mean([minmax_normalize(s) for s in all_scores], axis=0)
    return ShiftProfile(scores=avg, outlier_blocks=detect_outliers(avg))


def save_profile(path: str, profile: ShiftProfile, ts: Sequence[int] | None = None) -> None:
    """Persist a calibration profile (and, optionally, the train timesteps of
    the calibration schedule) for the quality policy to read."""
    np.savez_compressed(
        path,
        scores=np.asarray(profile.scores, np.float32),
        outlier_blocks=np.asarray(profile.outlier_blocks, np.int64),
        ts=np.asarray(ts if ts is not None else (), np.int64),
    )


def load_profile(path: str) -> tuple[ShiftProfile, np.ndarray | None]:
    """Inverse of :func:`save_profile` -> (profile, calibration ts or None)."""
    with np.load(path) as z:
        profile = ShiftProfile(
            scores=np.asarray(z["scores"], np.float32),
            outlier_blocks=tuple(int(b) for b in z["outlier_blocks"]),
        )
        ts = np.asarray(z["ts"], np.int64) if "ts" in z.files else np.zeros((0,), np.int64)
    return profile, (ts if ts.size else None)
