"""Build and load the hand-written Hopper kernels.

Each CUDA source under ``csrc/`` has a plain C interface and is compiled on
first use by its own ``nvcc`` (all sources in parallel) into a shared
library under ``<repo>/build/kernels/``, named by a hash of the source and
flags so an edited source is rebuilt.  The libraries are loaded with
``ctypes``; every entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()``, which :func:`check`
turns into an exception.  :func:`launch` calls one with its operands'
device current, since a CUDA launch (and ``cudaFuncSetAttribute``) goes to
the calling thread's current device, not to the device of the pointers.

Nothing here runs at import: the CPU tests import every module on hosts
that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the sources, by library name
SOURCES = ("uniconv", "group_norm", "flash_attention", "stream_norm", "fused_matmul")

#: C entry points: name -> (library, argtypes[, restype]); restype defaults to int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    # x, w_hi, w_lo, bias (nullable), out, partials (nullable), B, H, W, Cin, Cout,
    # Cin_pad, Cout_pad, K, stride, bn, split, stream
    "uniconv_f32": (
        "uniconv", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    # out ints, their capacity: the tiling the plan in uniconv/ops.py assumes
    "uniconv_tiling": ("uniconv", [ctypes.POINTER(ctypes.c_int), _I]),
    # x, scale, bias, out, B, L, C, G, groups a slice, cluster, rows a block, on chip, eps,
    # silu, stream
    "group_norm_f32": (
        "group_norm", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    # rows a block, slice width, groups a slice, on chip -> bytes of shared memory
    "group_norm_smem": ("group_norm", [_I, _I, _I, _I], ctypes.c_long),
    # q, k, v, out, B, H, Hkv, Sq, Skv, Dh, causal, window, softcap, scale, stream
    "flash_attention_f32": (
        "flash_attention",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    ),
    # x, scale, bias (nullable), out, M, D, eps, rms, stream
    "stream_norm_f32": ("stream_norm", [_P, _P, _P, _P, _I, _I, _F, _I, _P]),
    "stream_norm_bf16": ("stream_norm", [_P, _P, _P, _P, _I, _I, _F, _I, _P]),
    # a, b, bias (nullable), out, partials, stats (both nullable), scratch (nullable), M, N,
    # K, epilogue, route, N tile, stream
    "fused_matmul_f32": (
        "fused_matmul", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "fused_matmul_bf16": (
        "fused_matmul", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
}

#: suffix of the entry point that takes each operand type
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_FUNCS: dict[str, ctypes._CFuncPtr] = {}
#: ptxas resource report of the last build, by library
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library; returns seconds."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            tmp,
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        )
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def sass_counts(name: str, opcodes=("HGMMA", "HMMA")) -> dict[str, int] | None:
    """How many SASS instructions of each opcode the built library ``name``
    holds (``cuobjdump -sass``), or None where the toolkit has no cuobjdump.
    ``HGMMA`` is a warpgroup (wgmma) product, ``HMMA`` an mma.sync one."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_lib_path(name))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    words = [ln.split() for ln in sass.splitlines()]
    return {op: sum(1 for w in words for tok in w if tok.split(".")[0] == op) for op in opcodes}


def get(fn: str) -> ctypes._CFuncPtr:
    """The C entry point ``fn``, building and loading its library on first use."""
    if fn not in _FUNCS:
        lib_name, argtypes, *restype = ENTRY_POINTS[fn]
        build_all()
        lib = ctypes.CDLL(str(_lib_path(lib_name)))
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype[0] if restype else ctypes.c_int
        _FUNCS[fn] = f
    return _FUNCS[fn]


def check(fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed: cudaError {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(fn: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` on ``args`` plus ``device``'s current
    stream, with ``device`` the current device for the call, and raise on
    its CUDA error."""
    with torch.cuda.device(device):
        check(fn, get(fn)(*args, stream_ptr(device)))


def forbid_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward of the kernel ``name``:
    under grad mode, on an operand that requires grad.  A kernel launched by
    ``data_ptr`` returns a tensor with no graph, so every weight behind it
    would lose its gradient without a word.  Called before a wrapper's CPU
    branch, so the CPU shows the refusal too."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward and an operand requires grad; "
            "differentiate the 'eager' backend, or call the kernel under torch.no_grad()"
        )


def require_cuda(name: str, *tensors, dtypes=(torch.float32,)) -> None:
    """Wrapper-side checks: device, dtype (one of ``dtypes``) and contiguity
    of kernel operands."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on one CUDA device")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expects one of {list(dtypes)}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
