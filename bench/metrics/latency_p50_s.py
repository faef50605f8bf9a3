"""Median latency, due time to decoded image, of the requests due in the
window (open loop)."""
from bench.counts import latencies, percentile


def read(record):
    return percentile(latencies(record, record["drain_s"]), 50)
