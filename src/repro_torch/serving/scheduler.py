"""Packing policies for the continuous-batching engine.

The port's own copy of ``repro/serving/scheduler.py``.  Two host-side
decisions per micro-step:

1. **Admission**: which queued request backfills a freed lane (FIFO, the
   best plan-aligned request within a small window, or, with the feature
   cache on, the warmest one; the sharded engine names the shard it
   backfills, and warmth is then that shard's ring's).
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

    def remove(self, rid: int) -> bool:
        """Drop a queued request by rid (cancellation before admission),
        keeping the survivors' order."""
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                return True
        return False

    def __len__(self) -> int:
        return len(self._queue)

    def next_request(
        self, lane_branches: Sequence[np.ndarray] = (), shard: int | None = None
    ):
        """Pop the request to admit next, or None if the queue is empty.

        ``lane_branches`` holds each in-flight lane's remaining branch
        vector (the backfilled shard's lanes on the sharded engine), and
        ``shard`` the shard being backfilled; FIFO ignores both.
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

    def _score(
        self, req, lane_branches: Sequence[np.ndarray], shard: int | None = None
    ) -> float:
        """Admission preference for one windowed request (higher = sooner)."""
        return self._alignment(req.branch_vector(), lane_branches)

    def _consider_window(self, lane_branches: Sequence[np.ndarray]) -> bool:
        """Whether window scoring can beat plain FIFO right now."""
        return len(lane_branches) > 0

    def next_request(
        self, lane_branches: Sequence[np.ndarray] = (), shard: int | None = None
    ):
        if not self._queue:
            return None
        if (
            not self._consider_window(lane_branches)
            or self.window == 1
            or self._head_skips >= self.max_head_skips
        ):
            self._head_skips = 0
            return self._queue.popleft()
        window = list(self._queue)[: self.window]
        scores = [self._score(r, lane_branches, shard) for r in window]
        best = int(np.argmax(scores))  # stable: FIFO wins ties
        self._head_skips = self._head_skips + 1 if best else 0
        self._queue.remove(window[best])
        return window[best]


class CacheAwareScheduler(PlanAwareScheduler):
    """Plan-aware admission that also prefers cache-warm requests.

    The windowed score adds ``warmth_weight * plan_warmth``, the fraction of
    the request's FULL steps that would hit a warm feature-cache slot now
    (:meth:`repro_torch.serving.cache.SlotRing.plan_warmth`).  With a
    sharded cache the warmth is that of the backfilled shard's ring, since
    reuse never crosses shards.  The starvation bounds are inherited;
    without an attached cache, or with a cold one, this is exactly
    :class:`PlanAwareScheduler`.
    """

    def __init__(self, window: int = 4, warmth_weight: float = 2.0):
        super().__init__(window)
        self.warmth_weight = warmth_weight
        self.cache = None

    def attach_cache(self, cache) -> None:
        """Called by the engine that owns the feature cache: a single ring,
        or the sharded engine's
        :class:`~repro_torch.serving.cache.ShardedFeatureCache`."""
        self.cache = cache

    def _score(
        self, req, lane_branches: Sequence[np.ndarray], shard: int | None = None
    ) -> float:
        score = super()._score(req, lane_branches, shard)
        if self.cache is not None:
            score += self.warmth_weight * self.cache.plan_warmth(req, shard)
        return score

    def _consider_window(self, lane_branches: Sequence[np.ndarray]) -> bool:
        # warmth can rank requests even when no lanes are in flight
        if self.cache is not None and self.cache.n_warm > 0:
            return True
        return super()._consider_window(lane_branches)

    def peek_warm_shard(self, shards: Sequence[int]) -> int | None:
        """The shard among ``shards`` whose ring would serve the largest
        share of some windowed request's FULL steps, or None when nothing in
        the window is warm anywhere.  The sharded engine asks before it
        commits to the emptiest shard, so a warm request lands where its
        slots are.  Read-only: ``plan_warmth`` counts no probe and touches
        no slot."""
        if self.cache is None or self.cache.n_warm == 0 or not self._queue:
            return None
        best_shard, best_warmth = None, 0.0
        for req in list(self._queue)[: self.window]:
            for s in shards:
                w = self.cache.plan_warmth(req, s)
                if w > best_warmth:
                    best_shard, best_warmth = s, w
        return best_shard
