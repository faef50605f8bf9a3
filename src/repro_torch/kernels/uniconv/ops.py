"""Uni-conv: the K x K "same" convolution on the (L = H*W, C) layout.

* :func:`uniconv_apply` is the plain PyTorch version, op for op the K*K
  shifted 1x1 matmuls of ``repro/models/unet.py::uniconv_apply``.
* :func:`uniconv` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/uniconv.cu``), which replaces
  ``repro/kernels/uniconv/kernel.py::uniconv`` plus the bias and stride of
  ``repro/kernels/uniconv/ops.py``.  It is an implicit GEMM over the K*K
  taps on the tensor cores in split-precision "3xTF32" (float32-level
  error; see the source for the design).  It takes the plain version only
  for a tensor that lies on the CPU.

The host side of the kernel's design lives here, in plain PyTorch that the
CPU tests reach: :func:`tf32_split` (the kernel's ``cvt.rna.tf32`` split,
in integer ops), :func:`prepare_weights` (the K-major ``w_hi`` / ``w_lo``
the kernel reads, cached per weight tensor by :func:`prepared_weights`) and
:func:`tile_plan` (the N tile and split-K from the shape alone).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: output rows per block (two 64-row warpgroups) and input channels per stage
BM, BK = 128, 16
#: the N tiles the kernel is instantiated for.  These, BM, BK and
#: :func:`blocks_per_sm` restate constants of ``csrc/uniconv.cu``;
#: :func:`check_tiling` holds them against the built kernel at first use
BN_CHOICES = (8, 32, 64, 160)
#: streaming multiprocessors of an H100: the least grid the plan aims for
TARGET_BLOCKS = 132
#: fewest ring stages a split-K part reduces over, and the most parts
MIN_STAGES_PER_SPLIT, MAX_SPLIT = 4, 16
#: split-K cost of one output element per part (write and read back its
#: float32 partial, 8 bytes at 3.35 TB/s), in units of one ring stage of a
#: block, taken as 1.2 us: chip_smoke.py's per-shape times on an H100 put a
#: stage at 1.5-2.5 us, so the partials' cost is weighted high, not low
REDUCE_STAGES_PER_ELEMENT = 8 / 3.35e12 / 1.2e-6


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value (ties away from zero), as float32: the
    ``cvt.rna.tf32.f32`` of the kernel, in integer ops on the bit pattern."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t = hi + lo`` to about 2**-22 relative, both TF32-representable."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


class TilePlan(NamedTuple):
    bm: int
    bn: int
    split: int
    #: blocks along M and N (the grid without split-K)
    m_tiles: int
    n_tiles: int
    #: ring stages of the whole reduction: K*K taps x Cin_pad / BK chunks
    stages: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.split


def pick_bn(cout: int) -> int:
    """N tile from Cout: the narrowest that holds a narrow Cout (3, 4 -> 8;
    32 -> 32), 160 for a multiple of 160 that 128 does not divide (320 =
    2 x 160), else 64 (640 = 10 x 64, 1280 = 20 x 64).  A 64-wide tile keeps
    a block's registers under 128 a thread, so two blocks share an SM; a
    160-wide one takes a whole SM but reads each activation tile once for
    half of Cout 320; each was the faster at its served Cout on an H100."""
    for bn in BN_CHOICES[:-1]:
        if cout <= bn:
            return bn
    return 160 if cout % 160 == 0 and cout % 128 else 64


def blocks_per_sm(bn: int) -> int:
    """Blocks an SM holds at once: two where the N tile keeps a thread's
    registers under 128 (BN <= 64), else one (the kernel's launch bounds)."""
    return 2 if bn <= 64 else 1


@functools.cache
def check_tiling() -> None:
    """Raise unless the built kernel reports (``uniconv_tiling``) the BM,
    BK, N tiles and blocks per SM that :func:`tile_plan` assumes."""
    buf = (ctypes.c_int * 32)()
    n = build.get("uniconv_tiling")(buf, len(buf))
    want = [BM, BK, len(BN_CHOICES)] + [v for bn in BN_CHOICES for v in (bn, blocks_per_sm(bn))]
    if list(buf[:max(n, 0)]) != want:
        raise RuntimeError(f"uniconv: kernel tiling {list(buf[:max(n, 0)])} != plan's {want}")


def tile_plan(m: int, cout: int, cin: int, ksize: int) -> TilePlan:
    """(BM, BN, split-K) of one conv from its shape alone.

    Every block of a grid walks the same number of stages, so a grid takes
    about ceil(blocks / slots) rounds of ceil(stages / split) stages, where
    slots = 132 SMs x :func:`blocks_per_sm`.  The split that minimises
    that, plus the partials' traffic, is chosen: it fills the card where
    the output tiles alone leave it short (sd_v14 levels 2-3, the stride-2
    and 1x1 convs there) and evens out a last round that would run nearly
    empty.  Each part keeps at least ``MIN_STAGES_PER_SPLIT`` stages."""
    bn = pick_bn(cout)
    m_tiles, n_tiles = -(-m // BM), -(-cout // bn)
    stages = ksize * ksize * (-(-cin // BK))
    slots = TARGET_BLOCKS * blocks_per_sm(bn)
    best = None
    for split in range(1, max(1, min(MAX_SPLIT, stages // MIN_STAGES_PER_SPLIT)) + 1):
        rounds = -(-m_tiles * n_tiles * split // slots)
        cost = rounds * -(-stages // split)
        if split > 1:
            cost += split * m * cout * REDUCE_STAGES_PER_ELEMENT
        if best is None or cost < best[0]:
            best = (cost, split)
    return TilePlan(BM, bn, best[1], m_tiles, n_tiles, stages)


def prepare_weights(w: torch.Tensor, bn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[K*K, Cin, Cout] weights -> (w_hi, w_lo), each [K*K, Cout_pad, Cin_pad]
    K-major and zero-padded (Cout_pad a multiple of ``bn``, Cin_pad of BK)."""
    nf, cin, cout = w.shape
    cin_pad, cout_pad = -(-cin // BK) * BK, -(-cout // bn) * bn
    wt = torch.zeros((nf, cout_pad, cin_pad), device=w.device, dtype=torch.float32)
    wt[:, :cout, :cin] = w.transpose(1, 2)
    hi, lo = tf32_split(wt)
    return hi.contiguous(), lo.contiguous()


#: id(weight) -> (weakref to it, its _version, bn, w_hi, w_lo)
_PREPARED: dict[int, tuple] = {}


def prepared_weights(w: torch.Tensor, bn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`prepare_weights`, once per weight tensor: cached by the
    tensor's identity and ``_version`` (an in-place update re-prepares);
    the entry goes when the tensor does."""
    key = id(w)
    hit = _PREPARED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version and hit[2] == bn:
        return hit[3], hit[4]
    hi, lo = prepare_weights(w, bn)
    if hit is None or hit[0]() is not w:
        weakref.finalize(w, _PREPARED.pop, key, None)
    _PREPARED[key] = (weakref.ref(w), w._version, bn, hi, lo)
    return hi, lo


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


def uniconv_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    hw: tuple[int, int],
    ksize: int,
    stride: int = 1,
) -> torch.Tensor:
    """:func:`uniconv_apply` in the argument order of :func:`uniconv`."""
    return uniconv_apply(w, b, x, hw, ksize, stride)


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
        return uniconv_plain(x, w, b, hw, ksize, stride)
    h, wdim = hw
    bsz, l, cin = x.shape
    nf, wcin, cout = w.shape
    if l != h * wdim or nf != ksize * ksize or wcin != cin or stride not in (1, 2):
        raise ValueError(f"uniconv: bad shapes x={tuple(x.shape)} w={tuple(w.shape)} hw={hw}")
    operands = (x, w) if b is None else (x, w, b)
    build.require_cuda("uniconv", *operands)
    if b is not None and b.shape != (cout,):
        raise ValueError(f"uniconv: bias shape {tuple(b.shape)}, want ({cout},)")
    check_tiling()
    ho, wo = -(-h // stride), -(-wdim // stride)
    plan = tile_plan(bsz * ho * wo, cout, cin, ksize)
    w_hi, w_lo = prepared_weights(w, plan.bn)
    out = torch.empty((bsz, ho * wo, cout), device=x.device, dtype=torch.float32)
    partials = None
    if plan.split > 1:
        partials = torch.empty((plan.split, bsz * ho * wo, cout), device=x.device,
                               dtype=torch.float32)
    build.launch(
        "uniconv_f32", x.device,
        x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), None if partials is None else partials.data_ptr(),
        bsz, h, wdim, cin, cout, w_hi.shape[2], w_hi.shape[1], ksize, stride, plan.bn,
        plan.split,
    )
    uniconv.launches += 1
    if plan.split > 1:
        uniconv.reduce_launches += 1
    return out


uniconv.launches = 0
#: split-K reduce launches, which follow their conv launch (not in ``launches``)
uniconv.reduce_launches = 0
