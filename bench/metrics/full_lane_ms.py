"""Device time of a FULL micro-step's model work per lane its U-Net ran on
(the program's ``repro.step_full`` ranges), ms: a FULL lane's cost at the
batch sizes the window ran."""


def read(record):
    calls = (record["trace"] or {}).get("calls", {}).get("step_full")
    lanes = sum(c[1] * c[2] for c in calls or ())
    return 1e3 * sum(c[3] for c in calls) / lanes if lanes else None
