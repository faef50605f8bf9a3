"""Median wait from due time to lane admission of the requests due in the
window that were admitted (the driver's ``queue_wait_s`` from submission,
plus the generator's lateness)."""
from bench.counts import due, percentile


def read(record):
    waits = [r["submitted"] - r["due"] + r["queue_wait_s"]
             for r in (record["requests"][i] for i in due(record))
             if r["queue_wait_s"] is not None]
    return percentile(waits, 50)
