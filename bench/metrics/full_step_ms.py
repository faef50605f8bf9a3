"""Mean device time of a FULL micro-step in the traced window, ms."""


def read(record):
    steps = (record["trace"] or {}).get("steps", {}).get("FULL")
    return 1e3 * sum(steps) / len(steps) if steps else None
