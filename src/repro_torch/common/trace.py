"""Named ranges on the profiler's clock: where the port's device work and its
host phases happen.

Tracing is on while a ``torch.profiler`` collects, and only then:
the flag is ``torch.autograd.profiler._is_profiler_enabled``, read at every
call, so an operator's profiler and the benchmark's ``--trace 1`` turn it on
with no knob.  Each range is then a ``torch.profiler.record_function``, on
the device trace's clock; kineto gives a range that launches work a
device-side twin, from its first kernel's start to its last one's end.  Off,
a range is one flag test that returns a shared null context: it computes no
cost and formats no name.

Two kinds of range:

* **work**, ``repro.<kind>|<operations>|<bytes>``: the device work inside it,
  counted as ``bench/flops.py`` counts it (each product once, two operations
  a multiply-add; each float32 input read once and each output written
  once).  Kinds: ``uniconv``, ``attention_core`` and ``stream_group_norm``
  (the backend calls, ``models/backend.py``), ``linear`` (the dense
  products outside them, ``models/unet.py`` and the attention call's
  out-projection), and ``step_full`` / ``step_sketch`` / ``step_refine``
  (a micro-step's model work, ``serving/lanes.py``), which carry the lanes
  advanced and the lanes in place of operations and bytes;
* **phase**, ``repro.<name>`` with no ``|``: a host phase of the engine
  (``engine.backfill`` / ``vote`` / ``upload`` / ``dispatch`` / ``retire``)
  or of the driver (``driver.inbox`` / ``events``).

Kineto files each kernel under the innermost user range open at its launch
only.  A range that holds every kernel of a call, or its last, therefore
takes the device twin of a range opened around the same call, or cuts it
short.  ``bench/trace.py`` wraps the ``cuda`` backend's ``conv`` and
``attention`` calls in ranges its ``conv_roofline`` and
``attention_roofline`` read, so the ``uniconv`` range and the attention
call's out-projection ``linear`` range *yield*: they open only in the
outermost backend call on the thread (:func:`backend_call` counts them).
Nothing reads a wrapper's group-norm range, so ``stream_group_norm`` opens
inside any wrapper; the micro-step's range leaves its first and last
kernels to the range around it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

#: bytes of a float32
F32 = 4

_OFF = contextlib.nullcontext()


class _Calls(threading.local):
    #: backend calls open on this thread, counted while the profiler collects
    depth = 0


_calls = _Calls()


def phase(name: str):
    """``repro.<name>``, a host phase, while the profiler collects."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function("repro." + name)


def work(kind: str, cost: Callable[..., tuple[int, int]], *args: Any, yields: bool = False):
    """``repro.<kind>|<operations>|<bytes>`` with ``cost(*args)``'s two
    integers, while the profiler collects; with ``yields``, only in the
    outermost backend call on the thread."""
    if not _profiler._is_profiler_enabled or (yields and _calls.depth > 1):
        return _OFF
    ops, nbytes = cost(*args)
    return record_function(f"repro.{kind}|{int(ops)}|{int(nbytes)}")


def backend_call(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn``, a backend primitive, counted among the backend calls open on
    this thread while the profiler collects (see :func:`work`'s ``yields``)."""

    def call(*args, **kwargs):
        if not _profiler._is_profiler_enabled:
            return fn(*args, **kwargs)
        _calls.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _calls.depth -= 1

    return call


# -- costs: (operations, bytes) from shapes ----------------------------------


def conv_cost(x_shape, w_shape, hw, ksize: int, stride: int) -> tuple[int, int]:
    """A K x K conv: x [B, H*W, Cin], w [K*K, Cin, Cout], bias [Cout],
    output [B, H'*W', Cout] with H' = ceil(H / stride)."""
    b, _, cin = x_shape
    cout = w_shape[2]
    out = b * -(-hw[0] // stride) * -(-hw[1] // stride) * cout
    return 2 * out * cin * ksize * ksize, F32 * (
        b * hw[0] * hw[1] * cin + ksize * ksize * cin * cout + cout + out)


def attention_core_cost(q_shape, k_shape) -> tuple[int, int]:
    """Softmax attention over projected q [B, Lq, C] and k, v [B, Lk, C]:
    QK^T and PV, q, k and v read, the [B, Lq, C] output written."""
    b, lq, c = q_shape
    lk = k_shape[1]
    return 4 * b * lq * lk * c, F32 * (2 * b * lq * c + 2 * b * lk * c)


def dense_cost(*products) -> tuple[int, int]:
    """Products ``(x, w)`` or ``(x, w, bias)``: x's rows (all but its last
    axis) times w [K, N], the bias [N] added; the counts are the sums."""
    ops = nbytes = 0
    for x, w, *bias in products:
        rows = x.numel() // x.shape[-1]
        k, n = w.shape
        ops += 2 * rows * k * n
        nbytes += F32 * (rows * k + k * n + rows * n + sum(t.numel() for t in bias))
    return ops, nbytes


def group_norm_cost(x, p) -> tuple[int, int]:
    """A group norm over x with ``p = {"scale", "bias"}``: no products."""
    return 0, F32 * (2 * x.numel() + p["scale"].numel() + p["bias"].numel())

