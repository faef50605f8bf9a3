"""The traced run: spans the benchmark wraps around the program's layers,
the device trace of the window, and what it reduces to.

Until the program records spans of its own, the benchmark puts
``torch.profiler.record_function`` ranges around three calls:

* each backend ``conv`` / ``attention`` / ``group_norm`` call, named
  ``bench.<kind>|<operations>|<bytes>`` from the call's shapes, so every
  range carries its own work (``bench.flops`` counts it);
* each micro-step, named ``bench.step|<class>``;
* each ``engine.step`` (``bench.engine_step``), the host's whole step.

The profiler turns each range into a span on the device timeline from its
first kernel's start to its last kernel's end; a span's device time is the
time of the device operations inside it.  The hooks are installed only in
a traced run, before the engine is built.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Any

from bench import flops

CLASSES = ("FULL", "SKETCH", "REFINE")


def install(P: Any) -> None:
    """Wrap the program's ``cuda`` backend and micro-step builder (``P``:
    the program's modules) in named ranges."""
    from torch.profiler import record_function

    B, LN = P.backend, P.lanes
    cuda = B.resolve_backend("cuda")

    def conv(w, b, x, hw, ksize, stride=1):
        ops, nb = flops.conv_cost(x.shape, w.shape, hw, ksize, stride)
        with record_function(f"bench.conv|{ops}|{nb}"):
            return cuda.conv(w, b, x, hw, ksize, stride)

    def group_norm(x, p, groups, *, eps=1e-5, silu=False):
        with record_function(f"bench.group_norm|0|{flops.F32 * 2 * x.numel()}"):
            return cuda.group_norm(x, p, groups, eps=eps, silu=silu)

    def attention(q, k, v, o_proj, n_heads):
        ops, nb = flops.attention_cost(q.shape, k.shape, n_heads)
        with record_function(f"bench.attention|{ops}|{nb}"):
            return cuda.attention(q, k, v, o_proj, n_heads)

    B.CUDA = B.KernelBackend("cuda", conv, group_norm, attention)
    build = LN.make_micro_step

    def make_micro_step(*args, **kwargs):
        step = build(*args, **kwargs)

        def micro_step(state, b_star, *rest, **kw):
            with record_function(f"bench.step|{CLASSES[int(b_star)]}"):
                return step(state, b_star, *rest, **kw)

        return micro_step

    LN.make_micro_step = make_micro_step


class Tracer:
    """``torch.profiler`` over the window, started and stopped on the
    thread that drives the engine (the profiler records the host ops of
    the thread that starts it)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        self.prof.start()
        self.t0_ns = time.time_ns()  # the profiler's clock: nanoseconds of the epoch

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.stop()

    def step_range(self):
        from torch.profiler import record_function

        return record_function("bench.engine_step")

    def summary(self) -> dict:
        return summarize(self.prof.profiler.kineto_results, self.t0_ns, self.t1_ns)


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(results: Any, start_ns: int, end_ns: int, top: int = 10) -> dict:
    """Reduce a kineto trace of the window to what the readers use:

    * ``busy_s``: the union of device operations' intervals;
    * ``steps``: class -> device seconds of each micro-step span;
    * ``calls``: kind -> [[operations, bytes, calls, device seconds], ...];
    * ``device_ops``: the ``top`` device operations by total time;
    * ``idle_gaps``: the ``top`` host activities by the device idle time
      they cover (the deepest host range open at each gap's midpoint).
    """
    import torch

    cpu_type = torch.autograd.DeviceType.CPU
    dev: list[tuple[int, int]] = []
    by_name: dict[str, int] = collections.Counter()
    spans: list[tuple[int, int, str]] = []
    host: list[tuple[int, int, str]] = []
    for e in results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == cpu_type:
            if d > 0 and not e.is_user_annotation() or e.name().startswith("bench."):
                host.append((s, s + d, e.name()))
        elif e.is_user_annotation():
            spans.append((s, s + d, e.name()))
        elif d > 0:
            dev.append((s, s + d))
            by_name[e.name()] += d
    dev.sort()
    starts = [s for s, _ in dev]
    prefix = [0]
    for s, e in dev:
        prefix.append(prefix[-1] + (e - s))

    def busy_in(s: int, e: int) -> int:
        return prefix[bisect.bisect_left(starts, e)] - prefix[bisect.bisect_left(starts, s)]

    steps: dict[str, list[float]] = collections.defaultdict(list)
    calls: dict[tuple[str, int, int], list] = {}
    for s, e, name in spans:
        kind, *rest = name.split("|")
        if kind == "bench.step":
            steps[rest[0]].append(busy_in(s, e) / 1e9)
        elif len(rest) == 2:
            acc = calls.setdefault((kind[len("bench."):], int(rest[0]), int(rest[1])), [0, 0])
            acc[0] += 1
            acc[1] += busy_in(s, e)
    by_kind: dict[str, list] = collections.defaultdict(list)
    for (kind, ops, nb), (n, ns) in sorted(calls.items()):
        by_kind[kind].append([ops, nb, n, ns / 1e9])

    merged = _merge([(max(s, start_ns), min(e, end_ns)) for s, e in dev if e > start_ns])
    busy_ns = sum(e - s for s, e in merged)
    gaps, at = [], start_ns
    for s, e in merged + [(end_ns, end_ns)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    host.sort()
    host_starts = [s for s, _, _ in host]
    idle: dict[str, int] = collections.Counter()
    for s, e in gaps:
        mid = (s + e) // 2
        label, j = "driver outside engine.step", bisect.bisect_right(host_starts, mid) - 1
        for j in range(j, max(j - 4096, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] += e - s
    return dict(
        window_s=(end_ns - start_ns) / 1e9,
        busy_s=busy_ns / 1e9,
        device_ops_n=len(dev),
        steps=dict(steps),
        calls=dict(by_kind),
        device_ops=[[n[:120], ns / 1e9] for n, ns in by_name.most_common(top)],
        idle_gaps=[[n[:120], ns / 1e9] for n, ns in idle.most_common(top)],
    )
