"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The process loads the cell named in
``BENCHMARK.json``, builds the served engine on one card, warms it up,
fills its lanes, measures a window of ``--seconds``, checks a sample of
the window's outputs against the plain reference, and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; the
numbers compared with their limits come last, under ``check``, and again
as the last lines of standard error.

It exits non-zero and prints no result where no card is visible, where
the program is missing, or where JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fixed_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def outcome(record: dict) -> tuple[int, int]:
    """(attempted, failed): requests sent before the window closed, and
    those refused, failed, or (open loop) due in the window and not
    finished within the drain time."""
    from bench.counts import is_due

    close = record["window"]["close"]
    attempted = failed = 0
    for r in record["requests"].values():
        if r["submitted"] is None or r["submitted"] >= close:
            continue
        attempted += 1
        late = record["open_loop"] and r["done"] is None and is_due(record, r["due"])
        failed += bool(r["error"]) or late
    return attempted, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", help="also write the run's record (no outputs) to this JSON file")
    args = ap.parse_args(argv)

    fixed_caches(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from bench import check, serve
    from bench.traffic import Traffic

    record = serve.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = spec.reader(m.name)(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    traffic = Traffic(cell.mix, cell.config, args.seed, cell.model)
    verdict = check.check(cell, record, traffic, "cuda")
    attempted, failed = outcome(record)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(record["mem_peak"])}
    result = {"correct": bool(verdict["correct"]), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        t = record["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["check"] = dict(verdict["numbers"], requests_checked=len(verdict["checked"]))
    if args.record:
        keep = {k: v for k, v in record.items() if k != "outputs"}
        keep.update(result=result, power=power_limit())
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(keep, default=str))

    found = forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    lateness = [r["submitted"] - r["due"] for r in record["requests"].values()
                if r["due"] is not None and r["submitted"] is not None]
    if lateness:
        print(f"bench: generator lateness over {len(lateness)} requests: "
              f"max {max(lateness):.6f} s, mean {sum(lateness) / len(lateness):.6f} s",
              file=sys.stderr)
    for name, row in verdict["numbers"].items():
        print(f"bench: check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(f"bench: check requests {len(verdict['checked'])} of {record['cell']}, "
          f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
