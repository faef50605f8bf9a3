"""Lane-steps advanced over lane-steps computed (micro-steps x lanes) in
the window, from the engine's counters: the share of the batched U-Net
work that served a request."""


def read(record):
    c = record["counters"]
    if "open" not in c or "close" not in c:
        return None
    micro = c["close"]["micro_steps"] - c["open"]["micro_steps"]
    adv = c["close"]["lane_steps_advanced"] - c["open"]["lane_steps_advanced"]
    return adv / (micro * record["n_lanes"]) if micro else None
