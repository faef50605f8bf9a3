"""Roofline share of the group norms (the program's
``repro.stream_group_norm`` ranges, no products: their bytes bound them) in
the traced window, %."""
from bench.counts import trace_share


def read(record):
    return trace_share(record, "stream_group_norm")
