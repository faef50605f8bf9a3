"""Roofline share of all backend ``conv`` calls in the traced window, %:
the least time their operations and bytes allow on the chip over their
device time."""
from bench.counts import trace_share


def read(record):
    return trace_share(record, "conv")
