"""uniconv with and without the per-stage fold: error and time on the card.

``csrc/uniconv.cu`` adds each ring stage's tensor-core sum into a float32
accumulator with an ordinary add (``UNICONV_STAGE_FOLD=1``, the shipped
build).  This script builds the source a second time with
``-DUNICONV_STAGE_FOLD=0`` (one tensor-core accumulator over the whole
reduction) and runs both at the deepest sd_v14 served convs, split-K as
planned and forced to 1 (the longest chain), against the plain float32 conv
(chip_smoke.py's tolerance, 2e-5 relative to max(1, max |plain|)) and a
float64 one.  It prints each build's ptxas register report and one line per
case, and writes ``chiprun_out/uniconv_fold_ab.json``.  Needs a GPU and nvcc::

    PYTHONPATH=src python -m repro_torch.kernels.uniconv.fold_ab
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.uniconv import ops as U

#: (B, H, W, Cin, Cout, K) of the deepest served 3x3 convs, levels 3 to 0
SHAPES = [
    (4, 8, 8, 2560, 1280, 3),
    (4, 8, 8, 1280, 1280, 3),
    (4, 16, 16, 2560, 1280, 3),
    (4, 32, 32, 1920, 640, 3),
    (4, 64, 64, 960, 320, 3),
]
TOL = 2e-5
OUT = Path(__file__).resolve().parents[4] / "chiprun_out" / "uniconv_fold_ab.json"


def _build() -> dict[int, tuple[ctypes._CFuncPtr, list[str]]]:
    """Both builds, compiled in parallel: fold -> (uniconv_f32, ptxas lines)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for fold in (1, 0):
        lib = build.BUILD_DIR / f"libuniconv_fold{fold}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-DUNICONV_STAGE_FOLD={fold}", "-o",
               str(lib), str(build.CSRC / "uniconv.cu")]
        procs[fold] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for fold, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -DUNICONV_STAGE_FOLD={fold} failed:\n{log}")
        fn = ctypes.CDLL(str(lib)).uniconv_f32
        fn.argtypes, fn.restype = build.ENTRY_POINTS["uniconv_f32"][1], ctypes.c_int
        out[fold] = (fn, [ln.strip() for ln in log.splitlines() if "registers" in ln])
    return out


def _run(fn, x, w_hi, w_lo, bias, hw, cin, cout, k, bn, split) -> torch.Tensor:
    b = x.shape[0]
    m = b * hw[0] * hw[1]
    out = torch.empty((b, hw[0] * hw[1], cout), device=x.device)
    partials = torch.empty((split, m, cout), device=x.device) if split > 1 else None
    err = fn(x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), bias.data_ptr(), out.data_ptr(),
             None if partials is None else partials.data_ptr(), b, hw[0], hw[1], cin, cout,
             w_hi.shape[2], w_hi.shape[1], k, 1, bn, split, build.stream_ptr(x.device))
    build.check("uniconv_f32", err)
    return out


def _ms(f, reps: int = 20) -> float:
    for _ in range(3):
        f()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        f()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("fold_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0)
    print(f"[fold_ab] {card}")
    fns = _build()
    for fold, (_, regs) in fns.items():
        print(f"[fold_ab] UNICONV_STAGE_FOLD={fold} ptxas: {regs}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, wd, cin, cout, k in SHAPES:
        x = torch.randn((b, h * wd, cin), generator=gen, device="cuda")
        w = torch.randn((k * k, cin, cout), generator=gen, device="cuda") * (k * k * cin) ** -0.5
        bias = torch.randn((cout,), generator=gen, device="cuda")
        plain = U.uniconv_apply(w, bias, x, (h, wd), k)
        exact = U.uniconv_apply(w.double(), bias.double(), x.double(), (h, wd), k)
        scale = max(1.0, float(plain.abs().max()))
        plan = U.tile_plan(b * h * wd, cout, cin, k)
        w_hi, w_lo = U.prepare_weights(w, plan.bn)
        for split in sorted({plan.split, 1}, reverse=True):
            for fold, (fn, _) in fns.items():
                call = lambda: _run(fn, x, w_hi, w_lo, bias, (h, wd), cin, cout, k,  # noqa: E731
                                    plan.bn, split)
                got = call()
                row = dict(shape=[b, h * wd, cin, cout, k], bn=plan.bn, split=split,
                           stages=-(-plan.stages // split), fold=fold,
                           err_vs_f32=float((got - plain).abs().max()) / scale,
                           err_vs_f64=float((got.double() - exact).abs().max()) / scale,
                           plain_err_vs_f64=float((plain.double() - exact).abs().max()) / scale,
                           ms=_ms(call))
                row["within_tol"] = row["err_vs_f32"] <= TOL
                rows.append(row)
                print(f"[fold_ab] {row['shape']} bn {plan.bn} split {split} "
                      f"({row['stages']} stages a part) fold {fold}: rel err vs f32 "
                      f"{row['err_vs_f32']:.3g} vs f64 {row['err_vs_f64']:.3g} (plain vs f64 "
                      f"{row['plain_err_vs_f64']:.3g}) {'ok' if row['within_tol'] else 'OVER'} "
                      f"{row['ms']:.4f} ms")
        del x, w, plain, exact, w_hi, w_lo
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(dict(card=card, tol=TOL, rows=rows,
                                   ptxas={f: r for f, (_, r) in fns.items()}), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
