"""Mean device time of a SKETCH or REFINE micro-step in the traced window,
ms (the seed fixes the mix of the two; ``advance_eff`` shows a change)."""


def read(record):
    trace = (record["trace"] or {}).get("steps", {})
    steps = trace.get("SKETCH", []) + trace.get("REFINE", [])
    return 1e3 * sum(steps) / len(steps) if steps else None
