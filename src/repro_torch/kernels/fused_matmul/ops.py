"""Matrix product with a fused epilogue and optional per-row output statistics.

* :func:`fused_matmul_plain` is the plain PyTorch version of
  ``repro/kernels/fused_matmul/ref.py::fused_matmul_ref``: the product in
  float32, then the epilogue (none, bias, GELU in its sigmoid form
  ``y * sigmoid(1.702 y)``, SiLU), and with ``with_stats`` the per-row
  (sum, sum of squares) of that float32 result as ``[2, M]``, taken before
  the cast to ``a.dtype``.
* :func:`fused_matmul` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/fused_matmul.cu``), which replaces
  ``repro/kernels/fused_matmul/kernel.py::fused_matmul``.  a and b are both
  float32 or both bfloat16; :func:`matmul_plan` picks the route from the
  shape and type: bfloat16 on ``wgmma``, float32 in 3xTF32 on ``wgmma``
  (float32 accuracy on the TF32 tensor cores; b split per call into
  K-major halves), and a SIMT tile for small M.  The stats are
  deterministic per-tile partials added by a last launch.  It takes the
  plain version only for a tensor on the CPU.

With ``epilogue="none"`` a bias that is passed is ignored, as in the TPU
kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: epilogue name -> the kernel's code for it
EPILOGUES = {"none": 0, "bias": 1, "gelu": 2, "silu": 3}
#: route name -> the kernel's code for it
ROUTES = {"simt": 0, "tensor": 1}
#: up to this many rows the SIMT tile runs: a 128-row tile would be mostly padding
SMALL_M = 16
#: below this many tensor-core tiles (a quarter of an H100's 132 SMs) the SIMT
#: tile runs too: a grid that small is bound by latency, and the float32
#: route's split pass and the tiles' pipelines cost more than they save
SIMT_MAX_TILES = 32
#: output tile of each route and type (``csrc/fused_matmul.cu``): rows, and
#: the N tiles to choose from
SIMT_TILE = (64, (64,))
#: b's per-call TF32 split (float32 tensor route) is padded along K to this
SPLIT_K_PAD = 32
TENSOR_TILES = {torch.float32: (128, (128, 160)), torch.bfloat16: (128, (128,))}


class MatmulPlan(NamedTuple):
    route: str
    bm: int
    bn: int
    #: blocks along M and N; one stats partial per N tile
    m_tiles: int
    n_tiles: int


def matmul_plan(m: int, n: int, dtype: torch.dtype) -> MatmulPlan:
    """The route and output tile for out [m, n] of ``dtype``.  Tensor cores
    unless m <= :data:`SMALL_M` or the tensor tiles number fewer than
    :data:`SIMT_MAX_TILES`; float32 takes the N tile (128, four k8 steps a
    stage, or 160, two) that pads n least, bfloat16 128 (a 3-stage ring,
    two blocks an SM)."""
    bm, bns = TENSOR_TILES[dtype]
    bn = min(bns, key=lambda t: (-(-n // t) * t, bns.index(t)))
    plan = MatmulPlan("tensor", bm, bn, -(-m // bm), -(-n // bn))
    if m > SMALL_M and plan.m_tiles * plan.n_tiles >= SIMT_MAX_TILES:
        return plan
    bm, (bn,) = SIMT_TILE
    return MatmulPlan("simt", bm, bn, -(-m // bm), -(-n // bn))


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
    build.forbid_grad("fused_matmul", a, b, bias)
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
    plan = matmul_plan(m, n, a.dtype)
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    partials = stats = scratch = None
    if with_stats:
        partials = torch.empty((plan.n_tiles, 2, m), device=a.device, dtype=torch.float32)
        stats = torch.empty((2, m), device=a.device, dtype=torch.float32)
    if plan.route == "tensor" and a.dtype == torch.float32:
        # b's TF32 split, K-major and padded, made anew on every call
        k_pad = -(-k // SPLIT_K_PAD) * SPLIT_K_PAD
        scratch = torch.empty((2, plan.n_tiles * plan.bn, k_pad), device=a.device,
                              dtype=torch.float32)
    build.launch(
        f"fused_matmul_{build.DTYPE_SUFFIX[a.dtype]}", a.device,
        a.data_ptr(), b.data_ptr(), None if bi is None else bi.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if stats is None else stats.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        m, n, k, EPILOGUES[epilogue], ROUTES[plan.route], plan.bn,
    )
    fused_matmul.launches += 1
    return out, stats


fused_matmul.launches = 0
