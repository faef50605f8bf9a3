"""Uni-conv: the K x K "same" convolution on the (L = H*W, C) layout.

* :func:`uniconv_apply` is the plain PyTorch version, op for op the K*K
  shifted 1x1 matmuls of ``repro/models/unet.py::uniconv_apply``.
* :func:`uniconv` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/uniconv.cu``), which replaces
  ``repro/kernels/uniconv/kernel.py::uniconv`` plus the bias and stride of
  ``repro/kernels/uniconv/ops.py``.  It is an implicit GEMM over the K*K
  taps with masked, shifted loads staged in shared memory; bound by float32
  operations at the served shapes (see the source for the design).  It
  takes the plain version only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def uniconv_apply(
    w: torch.Tensor,  # [F=K*K, Cin, Cout]
    b: torch.Tensor | None,  # [Cout]
    x: torch.Tensor,  # [B, L=H*W, Cin]
    hw: tuple[int, int],
    ksize: int,
    stride: int = 1,
) -> torch.Tensor:
    """K x K conv as F 1x1 matmuls whose outputs land at remapped addresses."""
    h, wdim = hw
    bsz, l, cin = x.shape
    assert l == h * wdim, (l, h, wdim)
    pad = (ksize - 1) // 2
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(wdim, device=x.device)
    out = None
    for f in range(ksize * ksize):
        oy, ox = f // ksize - pad, f % ksize - pad
        part = (x @ w[f]).reshape(bsz, h, wdim, -1)
        # contribution of input l lands at output l - (oy, ox)
        sy, sx = -oy, -ox
        shifted = torch.roll(part, shifts=(sy, sx), dims=(1, 2))
        mask = ((rows >= sy) & (rows < h + sy))[:, None] & ((cols >= sx) & (cols < wdim + sx))[None]
        shifted = torch.where(mask[None, :, :, None], shifted, torch.zeros((), device=x.device))
        out = shifted if out is None else out + shifted
    assert out is not None
    if stride > 1:
        out = out[:, ::stride, ::stride, :]
    out = out.reshape(bsz, out.shape[1] * out.shape[2], -1)
    if b is not None:
        out = out + b
    return out


def uniconv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    hw: tuple[int, int],
    ksize: int,
    stride: int = 1,
) -> torch.Tensor:
    """Uni-conv through the Hopper kernel (the plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        return uniconv_apply(w, b, x, hw, ksize, stride)
    h, wdim = hw
    bsz, l, cin = x.shape
    nf, wcin, cout = w.shape
    if l != h * wdim or nf != ksize * ksize or wcin != cin or stride not in (1, 2):
        raise ValueError(f"uniconv: bad shapes x={tuple(x.shape)} w={tuple(w.shape)} hw={hw}")
    operands = (x, w) if b is None else (x, w, b)
    build.require_cuda_f32("uniconv", *operands)
    if b is not None and b.shape != (cout,):
        raise ValueError(f"uniconv: bias shape {tuple(b.shape)}, want ({cout},)")
    ho, wo = -(-h // stride), -(-wdim // stride)
    out = torch.empty((bsz, ho * wo, cout), device=x.device, dtype=torch.float32)
    fn = build.get("uniconv_f32")
    err = fn(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        bsz, h, wdim, cin, cout, ksize, stride, build.stream_ptr(x.device),
    )
    build.check("uniconv_f32", err)
    uniconv.launches += 1
    return out


uniconv.launches = 0
