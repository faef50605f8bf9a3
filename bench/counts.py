"""What happened inside a run's window, from its record (``bench.serve``):
the helpers the metric readers share."""
from __future__ import annotations

import numpy as np


def in_window(record: dict, t: float | None) -> bool:
    w = record["window"]
    return t is not None and w["open"] <= t < w["close"]


def lane_steps(record: dict) -> list[tuple[int, int]]:
    """(request, step index) of every denoising step a lane advanced inside
    the window."""
    return [(rid, step - 1) for t, rid, step in record["step_events"] if in_window(record, t)]


def finished(record: dict) -> list[int]:
    """Requests whose image was decoded inside the window."""
    return [i for i, r in record["requests"].items() if in_window(record, r["done"])]


def is_due(record: dict, t: float | None) -> bool:
    """Open loop: whether a due time lies in the scheduled window (the
    window's seconds from the time the mix opens it, after traffic starts)."""
    a, b = record["due_window"]
    return t is not None and a <= t < b


def due(record: dict) -> list[int]:
    """Open loop: requests due inside the window."""
    return [i for i, r in record["requests"].items() if is_due(record, r["due"])]


def latencies(record: dict, drain_s: float) -> list[float]:
    """Due time to decoded image of each request due in the window; one
    that failed or never finished counts as the longest it was given."""
    out = []
    for i in due(record):
        r = record["requests"][i]
        if r["done"] is None or r["error"]:
            out.append(record["window"]["close"] + drain_s - r["due"])
        else:
            out.append(r["done"] - r["due"])
    return out


def percentile(values: list[float], q: float) -> float | None:
    return float(np.percentile(values, q)) if values else None


def trace_share(record: dict, kind: str) -> float | None:
    """Roofline share of all ``kind`` backend calls in the traced window, %."""
    from bench.flops import least_seconds

    calls = (record["trace"] or {}).get("calls", {}).get(kind)
    if not calls:
        return None
    least = sum(n * least_seconds(ops, nb) for ops, nb, n, _ in calls)
    busy = sum(s for _, _, _, s in calls)
    return 100.0 * least / busy if busy > 0 else None
