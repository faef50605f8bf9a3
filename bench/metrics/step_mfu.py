"""Useful operations per second of the window over the chip's peak, %:
the operations of each lane-step advanced (one CFG pair of its class, as
the reference counts them) and of each image decoded in the window, over
the window's seconds, over 495 TFLOP/s (dense TF32)."""
from bench.counts import finished, lane_steps
from bench.flops import PEAK_FLOPS

CLASSES = ("FULL", "SKETCH", "REFINE")


def read(record):
    steps = lane_steps(record)
    if not steps:
        return None
    f = record["class_flops"]
    ops = sum(f[CLASSES[record["branches"][record["requests"][rid]["tier"]][k]]]
              for rid, k in steps)
    ops += f["DECODE"] * len(finished(record))
    return 100.0 * ops / record["window"]["s"] / PEAK_FLOPS
