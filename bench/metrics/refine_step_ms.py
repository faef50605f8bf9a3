"""Mean device time of a REFINE micro-step's model work in the traced
window (the program's ``repro.step_refine`` ranges), ms."""


def read(record):
    calls = (record["trace"] or {}).get("calls", {}).get("step_refine")
    n = sum(c[2] for c in calls or ())
    return 1e3 * sum(c[3] for c in calls) / n if n else None
