"""Serving metrics: latency percentiles, throughput, lane occupancy.

The port's own copy of the single-device, cache-off part of
``repro/serving/metrics.py``: one sample per micro-step (occupancy, advance
efficiency, executed branch class, host wall time) and one per completed
request (queue wait and latency), collapsed by :meth:`summary`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ServingMetrics:
    latencies_s: list[float] = dataclasses.field(default_factory=list)
    queue_waits_s: list[float] = dataclasses.field(default_factory=list)
    occupancy: list[float] = dataclasses.field(default_factory=list)
    advance_eff: list[float] = dataclasses.field(default_factory=list)
    micro_steps: int = 0
    lane_steps_advanced: int = 0
    #: lane-steps executed per branch class (FULL = a full U-Net pass)
    full_steps: int = 0
    sketch_steps: int = 0
    refine_steps: int = 0
    #: host wall seconds spent in ``engine.step`` per kernel backend
    #: (dispatch + any retirement sync): {backend: [count, total_s]}
    step_time_by_backend: dict[str, list] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0

    def record_step(
        self, n_lanes: int, n_active: int, n_advanced: int,
        n_full: int = 0, n_sketch: int = 0, n_refine: int = 0,
    ) -> None:
        self.micro_steps += 1
        self.lane_steps_advanced += n_advanced
        self.full_steps += n_full
        self.sketch_steps += n_sketch
        self.refine_steps += n_refine
        self.occupancy.append(n_active / max(n_lanes, 1))
        if n_active:
            self.advance_eff.append(n_advanced / n_active)

    def record_step_time(self, backend: str, seconds: float) -> None:
        acc = self.step_time_by_backend.setdefault(backend, [0, 0.0])
        acc[0] += 1
        acc[1] += seconds

    def record_completion(self, latency_s: float, queue_wait_s: float) -> None:
        self.latencies_s.append(latency_s)
        self.queue_waits_s.append(queue_wait_s)

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_s) if self.latencies_s else np.zeros(1)
        n = len(self.latencies_s)
        mean = lambda v: round(float(np.mean(v)), 3) if v else 0.0  # noqa: E731
        return {
            "requests": n,
            "wall_s": round(self.wall_s, 3),
            "throughput_req_s": round(n / self.wall_s, 3) if self.wall_s else 0.0,
            "p50_latency_s": round(float(np.percentile(lat, 50)), 3),
            "p99_latency_s": round(float(np.percentile(lat, 99)), 3),
            "mean_queue_wait_s": mean(self.queue_waits_s),
            "micro_steps": self.micro_steps,
            "lane_steps_advanced": self.lane_steps_advanced,
            "mean_occupancy": mean(self.occupancy),
            "mean_advance_eff": mean(self.advance_eff),
            "full_steps": self.full_steps,
            "sketch_steps": self.sketch_steps,
            "refine_steps": self.refine_steps,
            "step_time_by_backend": {
                k: {"steps": c, "mean_s": round(t / max(c, 1), 6)}
                for k, (c, t) in sorted(self.step_time_by_backend.items())
            },
        }
