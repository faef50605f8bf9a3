"""Share of the lanes the micro-steps' U-Net ran on that no request
advanced, in the traced window: one minus the lanes advanced over the
lanes computed, each micro-step's two integers (the program's
``repro.step_full`` / ``step_sketch`` / ``step_refine`` ranges) weighted
by its calls."""

KINDS = ("step_full", "step_sketch", "step_refine")


def read(record):
    calls = (record["trace"] or {}).get("calls", {})
    rows = [row for kind in KINDS for row in calls.get(kind, ())]
    computed = sum(lanes * n for _, lanes, n, _ in rows)
    return 1.0 - sum(adv * n for adv, _, n, _ in rows) / computed if computed else None
