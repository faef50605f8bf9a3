"""Matrix product with a fused epilogue and optional per-row output statistics.

* :func:`fused_matmul_plain` is the plain PyTorch version of
  ``repro/kernels/fused_matmul/ref.py::fused_matmul_ref``: the product in
  float32, then the epilogue (none, bias, GELU in its sigmoid form
  ``y * sigmoid(1.702 y)``, SiLU), and with ``with_stats`` the per-row
  (sum, sum of squares) of that float32 result as ``[2, M]``, taken before
  the cast to ``a.dtype``.
* :func:`fused_matmul` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/fused_matmul.cu``), which replaces
  ``repro/kernels/fused_matmul/kernel.py::fused_matmul``: a shared-memory
  tiled float32 SIMT GEMM whose epilogue runs in registers, with
  deterministic two-launch stats.  a and b are both float32 or both
  bfloat16; it takes the plain version only for a tensor on the CPU.

With ``epilogue="none"`` a bias that is passed is ignored, as in the TPU
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: epilogue name -> the kernel's code for it
EPILOGUES = {"none": 0, "bias": 1, "gelu": 2, "silu": 3}
#: output columns per block of the kernel, one stats partial per column tile
#: (``BN`` in ``csrc/fused_matmul.cu``)
BLOCK_N = 64


def _check_epilogue(epilogue: str) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"fused_matmul: epilogue {epilogue!r}, expected one of {list(EPILOGUES)}")


def fused_matmul_plain(
    a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None, *,
    epilogue: str = "none", with_stats: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """a [M, K] @ b [K, N] -> (out [M, N] in a.dtype, stats [2, M] float32 or None)."""
    _check_epilogue(epilogue)
    y = a.float() @ b.float()
    if epilogue != "none" and bias is not None:
        y = y + bias.float()
    if epilogue == "gelu":
        y = y * torch.sigmoid(1.702 * y)
    elif epilogue == "silu":
        y = y * torch.sigmoid(y)
    stats = torch.stack([y.sum(dim=-1), (y * y).sum(dim=-1)]) if with_stats else None
    return y.to(a.dtype), stats


def fused_matmul(
    a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None, *,
    epilogue: str = "none", with_stats: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The fused product through the Hopper kernel (plain version on a CPU tensor)."""
    _check_epilogue(epilogue)
    if a.device.type == "cpu":
        return fused_matmul_plain(a, b, bias, epilogue=epilogue, with_stats=with_stats)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or 0 in (*a.shape, b.shape[1]):
        raise ValueError(f"fused_matmul: a={tuple(a.shape)} b={tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"fused_matmul: a is {a.dtype}, b is {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    bi = None
    if epilogue != "none" and bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"fused_matmul: bias shape {tuple(bias.shape)}, want ({n},)")
        bi = bias.to(torch.float32).contiguous()
    build.require_cuda("fused_matmul", a, b, *(() if bi is None else (bi,)),
                       dtypes=tuple(build.DTYPE_SUFFIX))
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    partials = stats = None
    if with_stats:
        partials = torch.empty((-(-n // BLOCK_N), 2, m), device=a.device, dtype=torch.float32)
        stats = torch.empty((2, m), device=a.device, dtype=torch.float32)
    fn_name = f"fused_matmul_{build.DTYPE_SUFFIX[a.dtype]}"
    err = build.get(fn_name)(
        a.data_ptr(), b.data_ptr(), None if bi is None else bi.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if stats is None else stats.data_ptr(),
        m, n, k, EPILOGUES[epilogue], build.stream_ptr(a.device),
    )
    build.check(fn_name, err)
    fused_matmul.launches += 1
    return out, stats


fused_matmul.launches = 0
