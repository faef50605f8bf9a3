"""Group norm over the (L, C) layout with an optional fused SiLU epilogue.

* :func:`group_norm` is the plain PyTorch version of
  ``repro/models/unet.py::group_norm`` (one-pass mean and E[x^2], clamped
  variance); :func:`stream_group_norm_plain` adds the SiLU.
* :func:`stream_group_norm` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/group_norm.cu``), which replaces
  ``repro/kernels/stream_norm/kernel.py::stream_group_norm``.  It is bound by
  memory; a split-L statistics pass writes per-chunk partial sums so every
  SM has work, then an apply pass normalises, scales and applies the SiLU in
  one trip.  It takes the plain version only for a tensor on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: rows of one batch element per block of the statistics pass
CHUNK_ROWS = 64


def group_norm(x: torch.Tensor, p: dict, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """x: [B, L, C], one-pass sum / sum-of-squares statistics (paper Eq. 4)."""
    bsz, l, c = x.shape
    xg = x.float().reshape(bsz, l, groups, c // groups)
    s = xg.mean(dim=(1, 3), keepdim=True)
    sq = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(sq - s * s, min=0.0)
    y = (xg - s) * torch.rsqrt(var + eps)
    y = y.reshape(bsz, l, c) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def stream_group_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, groups: int,
    eps: float = 1e-5, silu: bool = False,
) -> torch.Tensor:
    y = group_norm(x, {"scale": scale, "bias": bias}, groups, eps)
    return y * torch.sigmoid(y) if silu else y


def stream_group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, groups: int,
    eps: float = 1e-5, silu: bool = False,
) -> torch.Tensor:
    """Group norm (+ SiLU) through the Hopper kernel (plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        return stream_group_norm_plain(x, scale, bias, groups=groups, eps=eps, silu=silu)
    bsz, l, c = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(
            f"stream_group_norm: x={tuple(x.shape)} scale={tuple(scale.shape)} groups={groups}"
        )
    build.require_cuda_f32("stream_group_norm", x, scale, bias)
    n_chunks = -(-l // CHUNK_ROWS)
    out = torch.empty_like(x)
    partials = torch.empty((bsz * groups * n_chunks * 2,), device=x.device, dtype=torch.float32)
    stats = torch.empty((bsz * groups * 2,), device=x.device, dtype=torch.float32)
    fn = build.get("group_norm_f32")
    err = fn(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partials.data_ptr(), stats.data_ptr(), bsz, l, c, groups, CHUNK_ROWS,
        float(eps), int(silu), build.stream_ptr(x.device),
    )
    build.check("group_norm_f32", err)
    stream_group_norm.launches += 1
    return out


stream_group_norm.launches = 0
