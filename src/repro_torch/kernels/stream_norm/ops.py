"""One-pass norms: the row layer/rms norm and the group norm over the
(L, C) layout with an optional fused SiLU epilogue.

* :func:`stream_norm_plain` is the plain PyTorch version of
  ``repro/kernels/stream_norm/kernel.py::_norm_kernel``: one-pass float32
  sum and sum of squares per row, clamped variance, ``rsqrt``; the bias is
  added in layernorm mode only.
* :func:`stream_norm` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/stream_norm.cu``), which replaces
  ``repro/kernels/stream_norm/kernel.py::stream_norm``: one block per row,
  the row cached in shared memory between statistics and apply, so x is read
  once.  It takes float32 or bfloat16 and takes the plain version only for a
  tensor on the CPU.
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
#: the row norms of :func:`stream_norm`
MODES = ("layernorm", "rmsnorm")


def stream_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None, *,
    mode: str = "layernorm", eps: float = 1e-6,
) -> torch.Tensor:
    """Norm over the last dim of x; statistics and arithmetic in float32,
    the result in ``x.dtype``.  Rmsnorm ignores ``bias``."""
    if mode not in MODES:
        raise ValueError(f"stream_norm: mode {mode!r}, expected one of {list(MODES)}")
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    s = xf.sum(dim=-1, keepdim=True) / d
    sq = (xf * xf).sum(dim=-1, keepdim=True) / d
    if mode == "layernorm":
        var = torch.clamp(sq - s * s, min=0.0)
        y = (xf - s) * torch.rsqrt(var + eps)
    else:
        y = xf * torch.rsqrt(sq + eps)
    y = y * scale.float()
    if mode == "layernorm" and bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape)


def stream_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None, *,
    mode: str = "layernorm", eps: float = 1e-6,
) -> torch.Tensor:
    """Row layer/rms norm through the Hopper kernel (plain version on a CPU tensor)."""
    if mode not in MODES:
        raise ValueError(f"stream_norm: mode {mode!r}, expected one of {list(MODES)}")
    if x.device.type == "cpu":
        return stream_norm_plain(x, scale, bias, mode=mode, eps=eps)
    if (x.dim() == 0 or x.numel() == 0 or scale.shape != x.shape[-1:]
            or (bias is not None and bias.shape != x.shape[-1:])):
        raise ValueError(f"stream_norm: x={tuple(x.shape)} scale={tuple(scale.shape)}")
    d = x.shape[-1]
    sc = scale.to(torch.float32).contiguous()
    bi = None if bias is None or mode == "rmsnorm" else bias.to(torch.float32).contiguous()
    build.require_cuda("stream_norm", x, sc, *(() if bi is None else (bi,)),
                       dtypes=tuple(build.DTYPE_SUFFIX))
    out = torch.empty_like(x)
    fn_name = f"stream_norm_{build.DTYPE_SUFFIX[x.dtype]}"
    err = build.get(fn_name)(
        x.data_ptr(), sc.data_ptr(), None if bi is None else bi.data_ptr(), out.data_ptr(),
        x.numel() // d, d, float(eps), int(mode == "rmsnorm"), build.stream_ptr(x.device),
    )
    build.check(fn_name, err)
    stream_norm.launches += 1
    return out


stream_norm.launches = 0


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
    build.require_cuda("stream_group_norm", x, scale, bias)
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
