"""Serving metrics: latency percentiles, throughput, lane occupancy, cache reuse.

The port's own copy of ``repro/serving/metrics.py``: one sample per
micro-step (occupancy, advance efficiency, executed and cache-demoted
branch classes, host wall time and the part of it blocked on the device,
and the sharded engine's active lanes per shard), one per submitted
request (its resolved quality tier) and one per completed request (queue
wait and latency), collapsed by :meth:`summary`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class ServingMetrics:
    latencies_s: list[float] = dataclasses.field(default_factory=list)
    queue_waits_s: list[float] = dataclasses.field(default_factory=list)
    occupancy: list[float] = dataclasses.field(default_factory=list)
    advance_eff: list[float] = dataclasses.field(default_factory=list)
    #: per-micro-step active-lane count per shard (sharded engine only)
    shard_active: list[list[int]] = dataclasses.field(default_factory=list)
    micro_steps: int = 0
    lane_steps_advanced: int = 0
    #: lane-steps executed per branch class (FULL = a full U-Net pass),
    #: demoted steps counted under the class they executed as
    full_steps: int = 0
    sketch_steps: int = 0
    refine_steps: int = 0
    #: planned-FULL lane-steps served from the feature cache as SKETCH
    demoted_steps: int = 0
    #: planned-SKETCH lane-steps served from the feature cache as REFINE
    demoted_refine_steps: int = 0
    #: executed demotions served from the device slot ring
    hbm_hits: int = 0
    #: spill-resident captures lifted back onto the device ring at admission
    spill_promotions: int = 0
    #: admissions the sharded engine redirected to a cache-warm shard
    gossip_routed: int = 0
    #: submitted requests per resolved quality tier ("full"/"pas" = no knob)
    quality_mix: dict[str, int] = dataclasses.field(default_factory=dict)
    #: host wall seconds spent in ``engine.step`` per kernel backend
    #: (dispatch + any retirement sync): {backend: [count, total_s]}
    step_time_by_backend: dict[str, list] = dataclasses.field(default_factory=dict)
    #: host seconds ``engine.step`` blocked on the device: the advance mask's
    #: upload (single-device engine), which waits for the queued micro-steps,
    #: and retirement's copies to the host
    step_wait_s: float = 0.0
    wall_s: float = 0.0

    def record_step(
        self, n_lanes: int, n_active: int, n_advanced: int,
        n_full: int = 0, n_sketch: int = 0, n_refine: int = 0,
        n_demoted: int = 0, n_demoted_refine: int = 0,
        shard_active: Sequence[int] | None = None,
    ) -> None:
        self.micro_steps += 1
        self.lane_steps_advanced += n_advanced
        self.full_steps += n_full
        self.sketch_steps += n_sketch
        self.refine_steps += n_refine
        self.demoted_steps += n_demoted
        self.demoted_refine_steps += n_demoted_refine
        # every executed demotion was served by a device-resident slot
        self.hbm_hits += n_demoted + n_demoted_refine
        self.occupancy.append(n_active / max(n_lanes, 1))
        if n_active:
            self.advance_eff.append(n_advanced / n_active)
        if shard_active is not None:
            self.shard_active.append(list(shard_active))

    def record_submission(self, tier: str) -> None:
        """Count one submitted request under its resolved quality tier."""
        self.quality_mix[tier] = self.quality_mix.get(tier, 0) + 1

    def record_step_time(self, backend: str, seconds: float) -> None:
        acc = self.step_time_by_backend.setdefault(backend, [0, 0.0])
        acc[0] += 1
        acc[1] += seconds

    def record_wait(self, seconds: float) -> None:
        self.step_wait_s += seconds

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
            "demoted_full_steps": self.demoted_steps,
            "demoted_sketch_steps": self.demoted_refine_steps,
            # fraction of planned FULL lane-steps served from the cache
            "cache_hit_rate": round(
                self.demoted_steps / max(self.full_steps + self.demoted_steps, 1), 3
            ),
            "hbm_hits": self.hbm_hits,
            "spill_promotions": self.spill_promotions,
            "gossip_routed": self.gossip_routed,
            "quality_mix": dict(sorted(self.quality_mix.items())),
            "step_time_by_backend": {
                k: {"steps": c, "mean_s": round(t / max(c, 1), 6)}
                for k, (c, t) in sorted(self.step_time_by_backend.items())
            },
            "step_wait_s": round(self.step_wait_s, 6),
            **self._shard_summary(),
        }

    def _shard_summary(self) -> dict:
        """Lane occupancy across shards (sharded engine only): each shard's
        mean active lanes, and their min/max as ``shard_occupancy_balance``
        (1.0 = balanced admission, 0.0 = a shard sat idle the whole run)."""
        if not self.shard_active:
            return {}
        per_shard = np.asarray(self.shard_active, np.float64).mean(axis=0)
        peak = float(per_shard.max())
        return {
            "shard_mean_active": [round(float(v), 3) for v in per_shard],
            "shard_occupancy_balance": (
                round(float(per_shard.min()) / peak, 3) if peak > 0 else 0.0
            ),
        }
