"""Fault-tolerant training loop scaffolding and restart supervision.

The port's own copy of ``repro/runtime/fault_tolerance.py``:

* ``StragglerDetector``: EWMA of per-step wall time; flags steps slower
  than ``threshold x`` the moving mean.  The trainer logs the flagged
  steps; the router feeds it health-probe round trips, so a degraded
  replica shows in ``/stats`` before it fails.
* ``RestartBackoff``: deterministic exponential backoff for restart
  supervision (replica respawn, retry loops); resettable on recovery.
* ``PreemptionGuard``: SIGTERM handler; the loop checkpoints and exits
  cleanly inside the eviction grace window.
* ``FaultTolerantLoop``: checkpoint cadence + auto-resume + straggler
  logging wrapped around any step function.
* ``ElasticPlan``: given a failed device count, choose the largest
  runnable (data, model) sub-mesh and the batch re-sharding.

Stdlib only (the checkpoint import is type-only): the router runs this
module in a process that never loads torch.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:
    from repro_torch.checkpoint.manager import CheckpointManager


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


class PreemptionGuard:
    """SIGTERM-aware flag; ``requested`` flips when eviction is signaled."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Re-mesh decision after losing ``failed`` chips from (data x model)."""

    old_data: int
    old_model: int
    new_data: int
    new_model: int
    new_global_batch: int  # trimmed so it shards evenly over new_data
    batch_per_data_shard: int

    @staticmethod
    def plan(data: int, model: int, failed: int, global_batch: int) -> "ElasticPlan":
        # model-parallel groups are the atomic unit: losing any chip kills
        # its whole TP group, so we drop ceil(failed / model) data rows.
        # We KEEP every healthy row and trim the global batch to the
        # largest multiple of new_data instead of dropping healthy rows
        # until the old batch divides (which can waste ~half the fleet).
        lost_rows = -(-failed // model)
        new_data = data - lost_rows
        if new_data < 1:
            raise RuntimeError("not enough healthy rows to continue")
        per_shard = global_batch // new_data
        if per_shard < 1:
            raise RuntimeError("global batch smaller than the surviving mesh")
        new_batch = per_shard * new_data
        return ElasticPlan(data, model, new_data, model, new_batch, per_shard)


@dataclasses.dataclass
class FaultTolerantLoop:
    ckpt: CheckpointManager
    save_every: int = 100
    max_steps: int = 1000
    straggler: StragglerDetector = dataclasses.field(default_factory=StragglerDetector)

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        *,
        guard: PreemptionGuard | None = None,
        log: Callable[[str], None] = print,
    ) -> Any:
        guard = guard or PreemptionGuard(install=False)
        start = 0
        restored = self.ckpt.restore_latest(state)
        if restored is not None:
            start, state = restored
            log(f"[ft] resumed from step {start}")
        for step in range(start, self.max_steps):
            t0 = time.perf_counter()
            state = step_fn(state, step)
            dt = time.perf_counter() - t0
            if self.straggler.observe(step, dt):
                log(f"[ft] straggler at step {step}: {dt:.3f}s vs mean {self.straggler.mean:.3f}s")
            if guard.requested:
                self.ckpt.save(step + 1, state, extra={"preempted": True})
                log(f"[ft] preempted; checkpointed step {step + 1}")
                return state
            if (step + 1) % self.save_every == 0:
                self.ckpt.save(step + 1, state)
        return state
