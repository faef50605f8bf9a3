"""Packing policies for the continuous-batching engine.

The port's own copy of ``repro/serving/scheduler.py``'s ``FIFOScheduler``
and ``PlanAwareScheduler``.  Two host-side decisions per micro-step:

1. **Admission**: which queued request backfills a freed lane (FIFO, or
   the best plan-aligned request within a small window).
2. **Branch class**: which of FULL/SKETCH/REFINE the next micro-step runs
   (majority, with an aging override so no lane starves).
"""
from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np


class FIFOScheduler:
    """Strict arrival-order admission + majority branch selection."""

    #: micro-steps an active lane may sit unadvanced before its branch
    #: class is forced (starvation guard)
    patience: int = 8

    def __init__(self):
        self._queue: deque = deque()

    def add(self, request) -> None:
        self._queue.append(request)

    def __len__(self) -> int:
        return len(self._queue)

    def next_request(self, lane_branches: Sequence[np.ndarray] = ()):
        """Pop the request to admit next, or None if the queue is empty.

        ``lane_branches`` holds each in-flight lane's remaining branch
        vector; FIFO ignores it.
        """
        if not self._queue:
            return None
        return self._queue.popleft()

    def pick_branch(self, lane_classes: np.ndarray, stall_counts: np.ndarray) -> int:
        """Branch class for the next micro-step, from the active lanes'
        classes and their counts of consecutive unadvanced micro-steps."""
        if lane_classes.size == 0:
            raise ValueError("no active lanes")
        if stall_counts.size and int(stall_counts.max()) >= self.patience:
            return int(lane_classes[int(np.argmax(stall_counts))])
        return int(np.argmax(np.bincount(lane_classes, minlength=3)))  # ties toward FULL


class PlanAwareScheduler(FIFOScheduler):
    """FIFO within a window, preferring plan-aligned requests.

    Among the first ``window`` queued requests, admit the one whose branch
    plan agrees most often, step for step, with the in-flight lanes'
    remaining plans, so their FULL steps share micro-steps.  ``window=1`` is
    strict FIFO, and the queue head is forced after ``max_head_skips``
    bypasses.
    """

    max_head_skips: int = 4

    def __init__(self, window: int = 4):
        super().__init__()
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self._head_skips = 0

    @staticmethod
    def _alignment(req_branches: np.ndarray, lane_branches: Sequence[np.ndarray]) -> float:
        score = 0.0
        for lb in lane_branches:
            m = min(len(req_branches), len(lb))
            if m:
                score += float(np.mean(req_branches[:m] == lb[:m]))
        return score

    def next_request(self, lane_branches: Sequence[np.ndarray] = ()):
        if not self._queue:
            return None
        if not lane_branches or self.window == 1 or self._head_skips >= self.max_head_skips:
            self._head_skips = 0
            return self._queue.popleft()
        window = list(self._queue)[: self.window]
        scores = [self._alignment(r.branch_vector(), lane_branches) for r in window]
        best = int(np.argmax(scores))  # stable: FIFO wins ties
        self._head_skips = self._head_skips + 1 if best else 0
        self._queue.remove(window[best])
        return window[best]
