"""Readings that set a cell's check limits, on the chip, in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 --seconds 20 [--out FILE]

For each seed it serves the cell for a short window at the cell's own
load, long enough that as many requests finish in it as a run checks,
then runs the check (``bench/check.py``) twice on the same sample: on the
program's outputs (the program's reading), and with the reference computed
in TF32 put in the program's place (the control's reading: the next
precision below the configuration's float32).  A limit lies above every
program reading and below every control reading (``bench/limits``).
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell, record, traffic, device) -> dict:
    """The check's verdict on one run twice: on the program's outputs, and
    with the reference computed in TF32 put in the program's place (the
    control), which has to come out not correct."""
    from bench import check

    t = time.perf_counter()
    program = check.check(cell, record, traffic, device)
    t_ref = time.perf_counter() - t
    rids = program["checked"]
    tf32 = check.reference_outputs(cell, record, rids, device, "tf32", traffic)
    control = check.check(cell, dict(record, outputs={**record["outputs"], **tf32}), traffic,
                          device, refs=program["refs"])
    numbers = lambda v: {k: r["value"] for k, r in v["numbers"].items()}  # noqa: E731
    return {"checked": rids, "program": numbers(program), "control": numbers(control),
            "program_correct": program["correct"], "control_correct": control["correct"],
            "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import serve, spec
    from bench.run import fixed_caches
    from bench.traffic import Traffic

    fixed_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        record = serve.run_cell(cell, seed, args.seconds, False)
        traffic = Traffic(cell.mix, cell.config, seed, cell.model)
        row = dict(cell=cell.name, seed=seed, setup_s=record["setup_s"],
                   **control_readings(cell, record, traffic, "cuda"))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
