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
  memory and runs in one launch: each (batch element, slice of whole
  groups) is one thread-block cluster whose blocks split the rows, cache
  them in shared memory, and add their group partials over distributed
  shared memory in rank order (:func:`group_norm_plan`).  It takes the
  plain version only for a tensor on the CPU.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

#: group_norm.cu: threads a block, largest cluster, shared memory a block may take
GN_THREADS = 128
GN_MAX_CLUSTER = 16
SMEM_LIMIT = 232448
#: the residency model of the plan (H100): SMs, shared memory an SM holds,
#: the CUDA runtime's reserve per block, and blocks an SM holds at most (65536
#: registers at 56 a thread of 128 threads: ptxas, chip_smoke.py's build line)
SMS, SM_SMEM, BLOCK_RESERVE, GN_MAX_BLOCKS_PER_SM = 132, 233472, 1024, 9
#: the least grid the plan aims for, and the grid it prefers: about four
#: blocks an SM, each of at most 40 KB (on an H100, 16-block clusters of
#: such blocks beat smaller clusters and wider blocks at the served shapes
#: that fit in one round)
TARGET_BLOCKS, PREFERRED_BLOCKS, SMALL_BLOCK_BYTES = SMS, 512, 40 * 1024
#: a row of a slice should span whole 32-byte sectors, and 128 bytes where C allows
SECTOR_BYTES, SEGMENT_BYTES = 32, 128
#: the cluster sizes the plan picks from
GN_CLUSTERS = (1, 2, 4, 8, 16)
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
    build.forbid_grad("stream_norm", x, scale, bias)
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
    build.launch(
        f"stream_norm_{build.DTYPE_SUFFIX[x.dtype]}", x.device,
        x.data_ptr(), sc.data_ptr(), None if bi is None else bi.data_ptr(), out.data_ptr(),
        x.numel() // d, d, float(eps), int(mode == "rmsnorm"),
    )
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


class GroupNormPlan(NamedTuple):
    """One launch of ``group_norm.cu``: a cluster of ``cluster`` blocks per
    (batch element, slice of ``groups_per_slice`` whole groups), each block
    taking ``rows_per_block`` rows of its slice, cached in shared memory
    when ``on_chip`` (x read from HBM once), else read twice."""
    batch: int
    rows: int
    channels: int
    groups: int
    groups_per_slice: int
    cluster: int
    rows_per_block: int
    on_chip: bool
    smem_bytes: int

    @property
    def slice_width(self) -> int:
        return self.groups_per_slice * (self.channels // self.groups)

    @property
    def slices(self) -> int:
        return self.groups // self.groups_per_slice

    @property
    def blocks(self) -> int:
        return self.batch * self.slices * self.cluster



def group_norm_smem(rows_per_block: int, width: int, groups_per_slice: int,
                    on_chip: bool) -> int:
    """Bytes of shared memory of one block (``group_norm.cu::smem_floats``):
    the cached rows, per-column sums, per-column scale / bias, and the group
    partials and statistics."""
    cached = rows_per_block * width if on_chip else 0
    return 4 * (cached + 2 * max(4 * GN_THREADS, width) + 2 * width + 4 * groups_per_slice)


def waves(blocks: int, cluster: int, smem_bytes: int) -> int:
    """Rounds of resident clusters the grid takes, in the plan's residency
    model."""
    per_sm = min(GN_MAX_BLOCKS_PER_SM, SM_SMEM // (smem_bytes + BLOCK_RESERVE))
    clusters = max(1, SMS * per_sm // cluster)
    return -(-blocks // (clusters * cluster))


@functools.lru_cache(maxsize=None)
def group_norm_plan(b: int, l: int, c: int, groups: int) -> GroupNormPlan:
    """The launch for x [b, l, c] with ``groups`` groups.

    Among slices of whole groups and clusters of 1-16 blocks whose rows fit
    in shared memory, prefer in order: slice rows that span whole 32-byte
    sectors; slices that allow 16-byte access; the fewest rounds of
    resident clusters (:func:`waves`: a last round that is nearly empty
    costs as much as a full one); at least :data:`PREFERRED_BLOCKS` blocks;
    slice rows of 128 bytes or more; the smallest block above
    :data:`SMALL_BLOCK_BYTES` (any at or below it alike); the largest
    cluster; the widest slice.
    Where no cluster can hold the rows, the widest sector-spanning slice at
    the largest cluster reads x twice."""
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_plan: {c} channels in {groups} groups")
    cg = c // groups
    sector, segment = min(SECTOR_BYTES, 4 * c), min(SEGMENT_BYTES, 4 * c)
    best = None
    for gps in (d for d in range(1, groups + 1) if groups % d == 0):
        width = gps * cg
        for cs in GN_CLUSTERS:
            rows = -(-l // cs)
            if cs > 1 and rows * (cs - 1) >= l:
                continue  # a block with no rows
            smem = group_norm_smem(rows, width, gps, True)
            if smem > SMEM_LIMIT:
                continue
            plan = GroupNormPlan(b, l, c, groups, gps, cs, rows, True, smem)
            key = (4 * width < sector, width % 4 != 0 and c % 4 == 0,
                   waves(plan.blocks, cs, smem), plan.blocks < PREFERRED_BLOCKS,
                   4 * width < segment, max(smem, SMALL_BLOCK_BYTES), -cs, -width)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is not None:
        return best[1]
    gps = next(d for d in range(1, groups + 1) if groups % d == 0 and 4 * d * cg >= sector)
    rows = -(-l // GN_MAX_CLUSTER)
    return GroupNormPlan(b, l, c, groups, gps, GN_MAX_CLUSTER, rows, False,
                         group_norm_smem(rows, gps * cg, gps, False))


@functools.lru_cache(maxsize=None)
def _check_smem(plan: GroupNormPlan) -> None:
    """The kernel's own count of its shared memory must be the plan's."""
    got = build.get("group_norm_smem")(
        plan.rows_per_block, plan.slice_width, plan.groups_per_slice, int(plan.on_chip))
    if got != plan.smem_bytes:
        raise RuntimeError(f"group_norm: kernel needs {got} B of shared memory, plan says "
                           f"{plan.smem_bytes}")


def stream_group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, groups: int,
    eps: float = 1e-5, silu: bool = False,
) -> torch.Tensor:
    """Group norm (+ SiLU) through the Hopper kernel (plain version on a CPU tensor)."""
    build.forbid_grad("stream_group_norm", x, scale, bias)
    if x.device.type == "cpu":
        return stream_group_norm_plain(x, scale, bias, groups=groups, eps=eps, silu=silu)
    bsz, l, c = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(
            f"stream_group_norm: x={tuple(x.shape)} scale={tuple(scale.shape)} groups={groups}"
        )
    build.require_cuda("stream_group_norm", x, scale, bias)
    plan = group_norm_plan(bsz, l, c, groups)
    _check_smem(plan)
    out = torch.empty_like(x)
    build.launch(
        "group_norm_f32", x.device,
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz, l, c, groups,
        plan.groups_per_slice, plan.cluster, plan.rows_per_block, int(plan.on_chip),
        float(eps), int(silu),
    )
    stream_group_norm.launches += 1
    return out


stream_group_norm.launches = 0
