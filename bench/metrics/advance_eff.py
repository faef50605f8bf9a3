"""Lane-steps advanced over micro-steps x lanes in the window, from the
engine's counters: how fully the branch vote packs the lanes' plans into
micro-steps.  The U-Net runs on the advancing lanes only, so a poor
packing costs micro-steps (host time and launches), not device work on
idle lanes."""


def read(record):
    c = record["counters"]
    if "open" not in c or "close" not in c:
        return None
    micro = c["close"]["micro_steps"] - c["open"]["micro_steps"]
    adv = c["close"]["lane_steps_advanced"] - c["open"]["lane_steps_advanced"]
    return adv / (micro * record["n_lanes"]) if micro else None
