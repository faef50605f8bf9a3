"""Restart supervision primitives of the replica router.

The port's own copy of the two pieces of ``repro/runtime/fault_tolerance.py``
that the router uses:

* ``StragglerDetector``: EWMA of per-step wall time; flags steps slower
  than ``threshold x`` the moving mean.  The router feeds it health-probe
  round trips, so a degraded replica shows in ``/stats`` before it fails.
* ``RestartBackoff``: deterministic exponential backoff for restart
  supervision (replica respawn, retry loops); resettable on recovery.

Stdlib only: the router runs it in a process that never builds an engine.
"""
from __future__ import annotations


class StragglerDetector:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.mean: float | None = None
        self.count = 0
        self.flagged: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = self.count > self.warmup and dt > self.threshold * self.mean
        if is_straggler:
            self.flagged.append((step, dt, self.mean))
        else:
            # stragglers are excluded from the EWMA so one hiccup does not
            # mask the next
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
        return is_straggler


class RestartBackoff:
    """Deterministic exponential backoff for restart supervision.

    ``next_delay()`` returns the wait before the *next* restart attempt and
    advances the failure count; ``reset()`` is called once the restarted
    unit is healthy again, so an isolated crash pays ``base_s`` while a
    crash loop walks up to ``max_s`` and stays there.  No jitter: restart
    schedules stay reproducible in tests and in the router's supervision
    log.
    """

    def __init__(self, base_s: float = 0.5, factor: float = 2.0, max_s: float = 30.0):
        if base_s <= 0:
            raise ValueError("base_s must be > 0")
        if factor < 1:
            raise ValueError("factor must be >= 1")
        if max_s < base_s:
            raise ValueError("max_s must be >= base_s")
        self.base_s = base_s
        self.factor = factor
        self.max_s = max_s
        self.failures = 0

    def next_delay(self) -> float:
        delay = min(self.base_s * self.factor**self.failures, self.max_s)
        self.failures += 1
        return delay

    def reset(self) -> None:
        self.failures = 0
