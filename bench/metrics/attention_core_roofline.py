"""Roofline share of the attention cores (the program's
``repro.attention_core`` ranges: QK^T, softmax and PV of each backend
attention call, without its output projection) in the traced window, %."""
from bench.counts import trace_share


def read(record):
    return trace_share(record, "attention_core")
