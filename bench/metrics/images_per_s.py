"""Images of denoising completed in the window, per second: each step a
lane advances counts 1/T of its T-step request, so a request served wholly
inside the window counts one image, and one cut by an edge its share."""
from bench.counts import lane_steps


def read(record):
    steps = lane_steps(record)
    if not steps:
        return None
    n = sum(1.0 / record["requests"][rid]["steps"] for rid, _ in steps)
    return n / record["window"]["s"]
