"""Roofline share of all backend ``attention`` calls (softmax attention
and its output projection) in the traced window, %."""
from bench.counts import trace_share


def read(record):
    return trace_share(record, "attention")
