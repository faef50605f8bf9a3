"""The host side of the group norm and fused_matmul kernels' designs, on the CPU.

``kernels/csrc/group_norm.cu`` runs group norm in one launch on thread-block
clusters, and ``kernels/csrc/fused_matmul.cu`` runs its products on the
tensor cores (``wgmma``: bfloat16, and float32 in 3xTF32).  The
kernels run only on a GPU; what they rest on is tested here:

* :func:`group_norm_plan` at every group norm shape the sd_v14 served path
  launches (one FULL micro-step at CFG batch 4: 61 calls over 15 shapes)
  and at the VAE's: the grid covers rows x channels once, clusters of at
  most 16 blocks, shared memory within the card's 232,448 bytes, the rows
  held on chip, and at least 132 blocks or the stated reason;
* the kernel's reduction order (per-block column sums, group sums, then
  the cluster's ranks in order), emulated in float32 from the plan, against
  the plain group norm;
* :func:`matmul_plan` at ``chip_smoke.py``'s seven product cases: the tiles
  cover the ragged edges once, and M = 4 takes the SIMT tile;
* the 3xTF32 product with a per-k8 fold, emulated with
  ``uniconv/ops.py::tf32_split``, against a float64 product at ff_out's
  K = 1280: within ``REG_TOL`` (1e-4 relative to max(1, max |ref|));
  measured 5.6e-7, the plain float32 product 6.1e-7, where one TF32
  product errs by 3.8e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_matmul.ops import (
    SIMT_MAX_TILES,
    SMALL_M,
    fused_matmul_plain,
    matmul_plan,
)
from repro_torch.kernels.stream_norm import ops as N
from repro_torch.kernels.uniconv.ops import tf32_split

#: (B, L, C, groups) -> calls of every group norm of one sd_v14 FULL
#: micro-step at CFG batch 4 (a shape-only walk of ``unet_apply``), with or
#: without SiLU; then the VAE decoder's one
SERVED_GROUP_NORMS = {
    (4, 64, 1280, 32): 12, (4, 64, 2560, 32): 3,
    (4, 256, 640, 32): 1, (4, 256, 1280, 32): 11, (4, 256, 1920, 32): 1,
    (4, 256, 2560, 32): 2,
    (4, 1024, 320, 32): 1, (4, 1024, 640, 32): 11, (4, 1024, 960, 32): 1,
    (4, 1024, 1280, 32): 1, (4, 1024, 1920, 32): 1,
    (4, 4096, 320, 32): 13, (4, 4096, 640, 32): 2, (4, 4096, 960, 32): 1,
}
VAE_GROUP_NORM = (1, 65536, 32, 8)
#: chip_smoke.py's fused_matmul cases: (label, M, K, N, epilogue, with_stats, dtype)
MATMUL_CASES = [
    ("ff_in", 16384, 320, 2560, "none", False, torch.float32),
    ("ff_out", 16384, 1280, 320, "none", False, torch.float32),
    ("self_o + ln2 stats", 16384, 320, 320, "none", True, torch.float32),
    ("GEGLU gate half", 16384, 320, 1280, "gelu", False, torch.float32),
    ("time MLP w1", 4, 320, 1280, "silu", False, torch.float32),
    ("GEGLU gate half bf16", 16384, 320, 1280, "gelu", False, torch.bfloat16),
    ("ragged", 96, 160, 224, "bias", True, torch.float32),
]
REG_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the CPU, and torch's
    spinning thread pool slows a crowded worker many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_served_group_norms_are_one_full_step():
    assert sum(SERVED_GROUP_NORMS.values()) == 61


def _max_blocks(b, l, c, groups):
    """The most blocks any plan may have: every slice of whole groups whose
    rows span a 32-byte sector, at the largest cluster with no empty block."""
    cg = c // groups
    sector = min(N.SECTOR_BYTES, 4 * c)
    gps = min(d for d in range(1, groups + 1) if groups % d == 0 and 4 * d * cg >= sector)
    cs = max(k for k in N.GN_CLUSTERS if k == 1 or -(-l // k) * (k - 1) < l)
    return b * (groups // gps) * cs


@pytest.mark.parametrize("shape", [*SERVED_GROUP_NORMS, VAE_GROUP_NORM])
def test_group_norm_plan_covers_once_and_fits(shape):
    b, l, c, groups = shape
    plan = N.group_norm_plan(b, l, c, groups)
    assert 1 <= plan.cluster <= N.GN_MAX_CLUSTER and groups % plan.groups_per_slice == 0
    assert plan.smem_bytes == N.group_norm_smem(
        plan.rows_per_block, plan.slice_width, plan.groups_per_slice, plan.on_chip)
    assert plan.smem_bytes <= N.SMEM_LIMIT
    # every served shape fits on chip: x crosses HBM once each way
    assert plan.on_chip
    # each slice row spans whole 32-byte sectors
    assert 4 * plan.slice_width >= min(N.SECTOR_BYTES, 4 * c)
    seen = np.zeros((b, l, c), dtype=np.int32)
    for rank in range(plan.cluster):
        r0 = rank * plan.rows_per_block
        r1 = min(l, r0 + plan.rows_per_block)
        assert r1 > r0, "a block with no rows"
        for s in range(plan.slices):
            seen[:, r0:r1, s * plan.slice_width:(s + 1) * plan.slice_width] += 1
    assert (seen == 1).all()
    # enough blocks for 132 SMs, or as many as the rules allow: the VAE's
    # one batch element of 8 groups of 4 channels has 4 sector-wide slices
    # and clusters of at most 16 blocks, so 64
    assert plan.blocks >= N.TARGET_BLOCKS or plan.blocks == _max_blocks(*shape)
    if plan.blocks < N.TARGET_BLOCKS:
        assert shape == VAE_GROUP_NORM and plan.blocks == 64


def test_group_norm_plan_reads_twice_only_where_no_cluster_holds_the_rows():
    plan = N.group_norm_plan(1, 1_000_000, 64, 8)
    assert not plan.on_chip and plan.cluster == N.GN_MAX_CLUSTER
    assert plan.rows_per_block * plan.cluster >= 1_000_000
    assert plan.smem_bytes <= N.SMEM_LIMIT


def _emulate_group_norm(x, scale, bias, groups, plan, eps=1e-5, silu=False):
    """group_norm.cu's order of sums, in float32: each block's column sums
    over its rows, its group sums over the columns, then every block of the
    cluster adds the ranks' partials in rank order."""
    b, l, c = x.shape
    cg, sw = c // groups, plan.slice_width
    out = torch.empty_like(x)
    for bi in range(b):
        for s in range(plan.slices):
            cols = slice(s * sw, (s + 1) * sw)
            parts = []
            for rank in range(plan.cluster):
                rows = x[bi, rank * plan.rows_per_block:(rank + 1) * plan.rows_per_block, cols]
                colsum, colsq = rows.sum(0), (rows * rows).sum(0)
                parts.append((colsum.reshape(-1, cg).sum(1), colsq.reshape(-1, cg).sum(1)))
            tot_s = torch.zeros(plan.groups_per_slice)
            tot_q = torch.zeros(plan.groups_per_slice)
            for ps, pq in parts:
                tot_s, tot_q = tot_s + ps, tot_q + pq
            n = float(l * cg)
            mean = tot_s / n
            rstd = 1.0 / torch.sqrt(torch.clamp(tot_q / n - mean * mean, min=0.0) + eps)
            y = (x[bi, :, cols] - mean.repeat_interleave(cg)) * rstd.repeat_interleave(cg)
            y = y * scale[cols] + bias[cols]
            out[bi, :, cols] = y * torch.sigmoid(y) if silu else y
    return out


@pytest.mark.parametrize("shape", [(2, 256, 64, 8), (1, 4096, 32, 8), (2, 100, 36, 4)])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_plan_order_matches_plain(shape, silu):
    b, l, c, groups = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(b, l, c)).astype(np.float32)) + 0.5
    scale = torch.from_numpy(rng.normal(size=c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=c).astype(np.float32))
    want = N.stream_group_norm_plain(x, scale, bias, groups=groups, silu=silu)
    plans = [N.group_norm_plan(b, l, c, groups)]
    # and a 16-block cluster of one-group slices, as the largest shapes take
    plans.append(plans[0]._replace(groups_per_slice=1, cluster=16, rows_per_block=-(-l // 16)))
    for plan in plans:
        got = _emulate_group_norm(x, scale, bias, groups, plan, silu=silu)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", MATMUL_CASES, ids=[c[0] for c in MATMUL_CASES])
def test_matmul_plan_covers_ragged_edges_once(case):
    _, m, _, n, _, with_stats, dtype = case
    plan = matmul_plan(m, n, dtype)
    tiles = -(-m // 128) * -(-n // (160 if n == 320 and dtype == torch.float32 else 128))
    assert plan.route == ("simt" if m <= SMALL_M or tiles < SIMT_MAX_TILES else "tensor")
    # the last tile along each dimension holds the edge, and no tile is empty
    assert (plan.m_tiles - 1) * plan.bm < m <= plan.m_tiles * plan.bm
    assert (plan.n_tiles - 1) * plan.bn < n <= plan.n_tiles * plan.bn
    if plan.route == "tensor":
        assert plan.bm == 128
        assert plan.bn in ((128,) if dtype == torch.bfloat16 else (128, 160))
    # the float32 N tile pads N least: 320 takes 160
    if n == 320:
        assert plan.bn == (160 if dtype == torch.float32 else 128)


def test_small_products_take_the_simt_tile():
    """The time MLP (M = 4) and the ragged case (one row of tiles) run SIMT;
    every full-width case of chip_smoke.py but the time MLP on the tensor cores."""
    assert matmul_plan(4, 1280, torch.float32).route == "simt"
    assert matmul_plan(4, 1280, torch.bfloat16).route == "simt"
    assert matmul_plan(96, 224, torch.float32).route == "simt"
    assert matmul_plan(SMALL_M + 1, 128 * SIMT_MAX_TILES, torch.float32).route == "tensor"
    for _, m, _, n, _, _, dtype in MATMUL_CASES:
        if m == 16384:
            assert matmul_plan(m, n, dtype).route == "tensor"


def _matmul_3xtf32(a, b, fold_k=8):
    """fused_matmul.cu's float32 route: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi of
    each k8 step from zero (products of TF32 values are exact in float32),
    folded into a float32 accumulator with an ordinary add."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], fold_k):
        ks = slice(k0, k0 + fold_k)
        d = a_lo[:, ks] @ b_hi[ks]
        d = d + a_hi[:, ks] @ b_lo[ks]
        acc = acc + (d + a_hi[:, ks] @ b_hi[ks])
    return acc


def test_3xtf32_product_at_ff_out_depth_keeps_float32_accuracy():
    """ff_out's K = 1280, inputs as chip_smoke.py draws them (b scaled by
    K**-0.5): 3xTF32 within REG_TOL of float64 (measured 5.6e-7), where one
    TF32 product (a_hi @ b_hi) misses it (measured 3.8e-4)."""
    rng = np.random.default_rng(4)
    k = 1280
    a = torch.from_numpy(rng.normal(size=(64, k)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(k, 320)) * k**-0.5).astype(np.float32))
    want = a.double() @ b.double()
    scale = max(1.0, float(want.abs().max()))
    err3 = float((_matmul_3xtf32(a, b).double() - want).abs().max()) / scale
    a_hi, b_hi = tf32_split(a)[0], tf32_split(b)[0]
    err1 = float(((a_hi @ b_hi).double() - want).abs().max()) / scale
    assert err3 <= REG_TOL / 100
    assert err1 > REG_TOL
    # the fused epilogue and stats of the plain version sit on that product
    out, stats = fused_matmul_plain(a, b, torch.zeros(320), epilogue="gelu", with_stats=True)
    assert out.shape == (64, 320) and stats.shape == (2, 64)
