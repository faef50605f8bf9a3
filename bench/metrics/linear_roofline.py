"""Roofline share of the dense products outside the hand-written kernels
(the program's ``repro.linear`` ranges: time MLP, ``t_proj``, self and
cross q/k/v, GEGLU in and out, and the attention out-projections where no
harness range wraps the attention call) in the traced window, %."""
from bench.counts import trace_share


def read(record):
    return trace_share(record, "linear")
