"""The readers of the micro-step ranges' two integers (lanes advanced,
lanes the U-Net ran on): ``unused_lane_share`` and ``full_lane_ms`` on
synthetic records, as ``bench.trace.summarize`` files the ranges (kind ->
[[advanced, lanes, calls, device seconds], ...]), and None where no step
range was traced."""
from __future__ import annotations

import pytest

from bench import spec

#: a window whose U-Net ran every micro-step on all 8 lanes
MASKED = {
    "step_full": [[3, 8, 2, 0.66], [8, 8, 1, 0.33]],
    "step_sketch": [[5, 8, 4, 0.52]],
    "step_refine": [[2, 8, 3, 0.23]],
}
#: the same micro-steps run on the advancing lanes alone
COMPACT = {
    "step_full": [[3, 3, 2, 0.26], [8, 8, 1, 0.33]],
    "step_sketch": [[5, 5, 4, 0.33]],
    "step_refine": [[2, 2, 3, 0.06]],
}


@pytest.mark.parametrize("calls, want", [
    (MASKED, 1 - (3 * 2 + 8 + 5 * 4 + 2 * 3) / (8 * 10)),
    (COMPACT, 0.0),
    ({"step_refine": [[2, 8, 3, 0.23]]}, 0.75),
], ids=["masked", "compact", "refine-only"])
def test_unused_lane_share(calls, want):
    read = spec.reader("unused_lane_share")
    assert read({"trace": {"calls": calls}}) == pytest.approx(want, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("calls, want", [
    (MASKED, 1e3 * 0.99 / 24),
    (COMPACT, 1e3 * 0.59 / 14),
], ids=["masked", "compact"])
def test_full_lane_ms(calls, want):
    read = spec.reader("full_lane_ms")
    assert read({"trace": {"calls": calls}}) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", ["unused_lane_share", "full_lane_ms"])
def test_nothing_to_read(metric):
    read = spec.reader(metric)
    assert read({"trace": None}) is None
    assert read({"trace": {"calls": {}}}) is None
    assert read({"trace": {"calls": {"linear": [[4, 96, 10, 0.004]]}}}) is None
    if metric == "full_lane_ms":  # partial steps alone: no FULL lane to time
        assert read({"trace": {"calls": {"step_refine": [[2, 8, 3, 0.23]]}}}) is None
