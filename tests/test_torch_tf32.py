"""The host side of the tensor-core kernels' design, on the CPU.

``kernels/csrc/uniconv.cu`` and ``flash_attention.cu`` compute float32
products on the TF32 tensor cores in split precision ("3xTF32": x = hi +
lo, a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, float32 accumulation).  The
kernels run only on a GPU; what they rest on is tested here:

* ``tf32_split``, the integer-op twin of the kernel's ``cvt.rna.tf32``;
* a plain emulation of the 3xTF32 product (used only here: products of
  TF32 values are exact in float32, so float32 matmuls of the split parts
  are what the tensor cores sum) against the float32 plain conv and
  attention within the kernels' tolerances (2e-5 / 1e-4 relative to
  max(1, max |plain|)), and at a depth where one TF32 product misses them;
* the weight preparation and its cache;
* the tile plan at every uniconv shape the sd_v14 served path launches
  (the shapes ``chip_smoke.py`` logged on an H100: it records them only on
  the card): the grid's tiles cover each output once, enough blocks or a
  stated reason, and the kernel's (tap, channel chunk) stages split over
  the parts add up to the conv.  That the kernel sums the parts in a fixed
  order is checked on the card (``tests/test_torch_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_ref
from repro_torch.kernels.uniconv import ops as U

#: kernel-vs-plain tolerances of chip_smoke.py, relative to max(1, max |plain|)
TOL_CONV, TOL_ATTN = 2e-5, 1e-4
#: (B, H, W, Cin, Cout, K, stride) of every distinct uniconv call of one FULL
#: and one SKETCH sd_v14 micro-step (CFG batch 4) and one VAE decode
SERVED_CONVS = [
    (1, 128, 128, 64, 64, 3, 1),
    (1, 64, 64, 4, 64, 1, 1),
    (1, 64, 64, 64, 64, 3, 1),
    (1, 256, 256, 32, 3, 3, 1),
    (1, 256, 256, 64, 32, 3, 1),
    (4, 32, 32, 1280, 640, 1, 1),
    (4, 32, 32, 1280, 1280, 3, 1),
    (4, 32, 32, 1280, 640, 3, 1),
    (4, 32, 32, 1920, 640, 1, 1),
    (4, 32, 32, 1920, 640, 3, 1),
    (4, 32, 32, 320, 640, 1, 1),
    (4, 32, 32, 320, 640, 3, 1),
    (4, 32, 32, 640, 640, 1, 1),
    (4, 32, 32, 640, 640, 3, 1),
    (4, 32, 32, 640, 640, 3, 2),
    (4, 32, 32, 960, 640, 1, 1),
    (4, 32, 32, 960, 640, 3, 1),
    (4, 16, 16, 1280, 1280, 1, 1),
    (4, 16, 16, 1280, 1280, 3, 1),
    (4, 16, 16, 1280, 1280, 3, 2),
    (4, 16, 16, 1920, 1280, 1, 1),
    (4, 16, 16, 1920, 1280, 3, 1),
    (4, 16, 16, 2560, 1280, 1, 1),
    (4, 16, 16, 2560, 1280, 3, 1),
    (4, 16, 16, 640, 1280, 1, 1),
    (4, 16, 16, 640, 1280, 3, 1),
    (4, 64, 64, 320, 320, 1, 1),
    (4, 64, 64, 320, 320, 3, 1),
    (4, 64, 64, 320, 320, 3, 2),
    (4, 64, 64, 320, 4, 3, 1),
    (4, 64, 64, 4, 320, 3, 1),
    (4, 64, 64, 640, 320, 1, 1),
    (4, 64, 64, 640, 320, 3, 1),
    (4, 64, 64, 640, 640, 3, 1),
    (4, 64, 64, 960, 320, 1, 1),
    (4, 64, 64, 960, 320, 3, 1),
    (4, 8, 8, 1280, 1280, 1, 1),
    (4, 8, 8, 1280, 1280, 3, 1),
    (4, 8, 8, 2560, 1280, 1, 1),
    (4, 8, 8, 2560, 1280, 3, 1),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the CPU, and torch's
    spinning thread pool slows a crowded worker many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max()) / max(1.0, float(want.abs().max()))


# -- the TF32 split ------------------------------------------------------------


def test_tf32_split_clears_13_bits_and_reconstructs():
    w = _t(np.random.default_rng(0).normal(size=(9, 64, 96)) * np.logspace(-3, 3, 96))
    hi, lo = U.tf32_split(w)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # hi carries 11 significant bits, lo the next 11: the rest is 2**-22 of w
    assert float(((hi + lo) - w).abs().div(w.abs()).max()) <= 2.0**-21
    assert float((hi - w).abs().div(w.abs()).max()) <= 2.0**-11


@pytest.mark.parametrize(
    "x,want",
    [
        (1 + 2**-11, 1 + 2**-10),  # a tie rounds away from zero
        (-(1 + 2**-11), -(1 + 2**-10)),
        (1 + 2**-11 - 2**-23, 1.0),
        (1 + 2**-10 + 2**-11, 1 + 2**-9),  # odd or even: away from zero
        (3.0, 3.0),
        (0.0, 0.0),
    ],
)
def test_tf32_round_is_nearest_ties_away(x, want):
    assert float(U.tf32_round(torch.tensor([x], dtype=torch.float32))[0]) == want


def test_bf16_weights_have_zero_lo():
    """sd_v14's weights are float32 tensors holding bfloat16 values (8-bit
    mantissa): TF32 (10 bits) holds them exactly, so w_lo is 0."""
    w = _t(np.random.default_rng(1).normal(size=(9, 32, 48))).to(torch.bfloat16).float()
    hi, lo = U.tf32_split(w)
    assert torch.equal(hi, w)
    assert int(lo.ne(0).sum()) == 0


# -- 3xTF32 against float32 -----------------------------------------------------


def _conv_3xtf32(x, w, b, hw, ksize, stride):
    x_hi, x_lo = U.tf32_split(x)
    w_hi, w_lo = U.tf32_split(w)
    out = U.uniconv_apply(w_hi, None, x_lo, hw, ksize, stride)
    out = out + U.uniconv_apply(w_lo, None, x_hi, hw, ksize, stride)
    return out + U.uniconv_apply(w_hi, b, x_hi, hw, ksize, stride)


@pytest.mark.parametrize(
    "side,cin,cout,ksize,stride",
    [(8, 32, 16, 3, 1), (8, 4, 8, 3, 1), (8, 64, 3, 3, 2), (4, 320, 64, 3, 1), (8, 96, 32, 1, 1)],
)
def test_3xtf32_conv_matches_float32(side, cin, cout, ksize, stride):
    """At narrow widths and in one deep product (K = 9 x 320 = 2880): the
    emulated 3xTF32 conv and the float32 plain conv each sit within a few
    1e-7 of the float64 conv, far inside the 2e-5 tolerance; one TF32
    product alone errs by about 2**-11 per term."""
    rng = np.random.default_rng(side + cin + cout)
    x = _t(rng.normal(size=(2, side * side, cin)))
    w = _t(rng.normal(size=(ksize * ksize, cin, cout)) * (ksize * ksize * cin) ** -0.5)
    b = _t(rng.normal(size=(cout,)))
    hw = (side, side)
    exact = U.uniconv_apply(w.double(), b.double(), x.double(), hw, ksize, stride)
    plain = U.uniconv_apply(w, b, x, hw, ksize, stride)
    emulated = _conv_3xtf32(x, w, b, hw, ksize, stride)
    one_tf32 = U.uniconv_apply(U.tf32_round(w), b, U.tf32_round(x), hw, ksize, stride)
    err_plain, err_3x = _rel_err(plain, exact), _rel_err(emulated, exact)
    assert _rel_err(emulated, plain) <= TOL_CONV
    assert err_3x <= 4 * max(err_plain, 2.0**-23) and err_3x <= TOL_CONV / 10
    depth = ksize * ksize * cin
    if depth >= 2880:
        assert _rel_err(one_tf32, exact) > TOL_CONV  # why one product is not enough


def test_3xtf32_error_grows_slowly_with_depth():
    """Error of the emulated 3xTF32 product against float64 over depths
    K = 9 x Cin: it grows like sqrt(K) times 2**-22 on unit-variance
    terms, so even K = 9 x 2560 stays below 1e-6 relative."""
    rng = np.random.default_rng(7)
    errs = []
    for cin in (32, 320, 2560):
        k = 9 * cin
        a = _t(rng.normal(size=(64, k)))
        bmat = _t(rng.normal(size=(k, 16)) * k**-0.5)
        a_hi, a_lo = U.tf32_split(a)
        b_hi, b_lo = U.tf32_split(bmat)
        got = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
        errs.append(_rel_err(got, a.double() @ bmat.double()))
    assert max(errs) < 1e-6, errs


def _attention_3xtf32(q, k, v):
    """The flash kernel's arithmetic: S from split (q / sqrt(Dh)) and k,
    float32 softmax, O from split (unnormalised) p and v, then / l."""
    qs = q * q.shape[-1] ** -0.5
    q_hi, q_lo = U.tf32_split(qs)
    k_hi, k_lo = U.tf32_split(k)
    v_hi, v_lo = U.tf32_split(v)
    t = lambda m: m.transpose(-1, -2)  # noqa: E731
    s = q_lo @ t(k_hi) + q_hi @ t(k_lo) + q_hi @ t(k_hi)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p_hi, p_lo = U.tf32_split(p)
    o = p_lo @ v_hi + p_hi @ v_lo + p_hi @ v_hi
    return o / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("sq,skv,dh", [(256, 256, 40), (64, 77, 80), (64, 64, 160)])
def test_3xtf32_attention_matches_float32(sq, skv, dh):
    rng = np.random.default_rng(sq + skv + dh)
    q, k, v = (_t(rng.normal(size=(1, 2, s, dh))) for s in (sq, skv, skv))
    plain = flash_attention_ref(q, k, v, causal=False)
    exact = flash_attention_ref(q.double(), k.double(), v.double(), causal=False)
    got = _attention_3xtf32(q, k, v)
    assert _rel_err(got, plain) <= TOL_ATTN / 10
    assert _rel_err(got, exact) <= TOL_ATTN / 10


# -- weight preparation ------------------------------------------------------------


def test_prepare_weights_layout():
    rng = np.random.default_rng(3)
    w = _t(rng.normal(size=(9, 20, 3)))
    hi, lo = U.prepare_weights(w, bn=8)
    assert hi.shape == lo.shape == (9, 8, 32)  # [K*K, Cout_pad, Cin_pad], K-major
    want_hi, want_lo = U.tf32_split(w.transpose(1, 2))
    assert torch.equal(hi[:, :3, :20], want_hi) and torch.equal(lo[:, :3, :20], want_lo)
    assert int(hi[:, 3:].ne(0).sum() + hi[:, :, 20:].ne(0).sum()) == 0
    assert int(lo[:, 3:].ne(0).sum() + lo[:, :, 20:].ne(0).sum()) == 0


def test_prepared_weights_cached_per_tensor_and_version():
    w = _t(np.random.default_rng(4).normal(size=(1, 16, 16)))
    first = U.prepared_weights(w, 32)
    assert U.prepared_weights(w, 32)[0] is first[0]
    assert U.prepared_weights(w.clone(), 32)[0] is not first[0]
    w.mul_(2.0)  # an in-place update bumps _version: prepared again
    again = U.prepared_weights(w, 32)
    assert again[0] is not first[0] and torch.equal(again[0], 2 * first[0])
    key = id(w)
    del w, first, again
    assert key not in U._PREPARED  # the entry goes with its tensor


# -- the tile plan ---------------------------------------------------------------


def _split_range(stages: int, split: int, part: int) -> tuple[int, int]:
    """Stages [lo, hi) that split-K part ``part`` reduces: the kernel's kt0 / kt1."""
    return stages * part // split, stages * (part + 1) // split


@pytest.mark.parametrize("shape", SERVED_CONVS, ids=lambda s: "x".join(map(str, s)))
def test_tile_plan_at_served_conv(shape):
    b, h, w, cin, cout, ksize, stride = shape
    m = b * (-(-h // stride)) * (-(-w // stride))
    plan = U.tile_plan(m, cout, cin, ksize)
    assert plan.bn in U.BN_CHOICES and plan.bm == U.BM
    if cout <= 32:
        assert cout <= plan.bn <= 32  # narrow VAE outputs: a narrow N tile
    elif cout >= 128:
        assert cout % plan.bn == 0  # 320 = 2 x 160, 640 = 10 x 64, 1280 = 20 x 64
    # the grid (blockIdx.x * BM, blockIdx.y * BN) covers [0, M) x [0, Cout)
    # once, with no tile wholly past either edge
    assert (plan.m_tiles - 1) * plan.bm < m <= plan.m_tiles * plan.bm
    assert (plan.n_tiles - 1) * plan.bn < cout <= plan.n_tiles * plan.bn
    assert plan.stages == ksize * ksize * -(-cin // U.BK)
    assert 1 <= plan.split <= U.MAX_SPLIT
    assert plan.split == 1 or plan.stages // plan.split >= U.MIN_STAGES_PER_SPLIT
    # enough blocks to fill the card, or why not: the reduction is too short
    # to split more, or one more part would add a round of the grid
    if plan.blocks < U.TARGET_BLOCKS:
        more = plan.split + 1
        slots = U.TARGET_BLOCKS * U.blocks_per_sm(plan.bn)
        tiles = plan.m_tiles * plan.n_tiles
        assert (
            plan.stages // more < U.MIN_STAGES_PER_SPLIT or more > U.MAX_SPLIT
            or -(-tiles * more // slots) > -(-plan.blocks // slots)
        )


def _im2col_stage(x, hw, ksize, stride, f, c0):
    """[M, BK] activations of ring stage (tap f, channels c0..c0+BK), zero
    outside the image and past Cin: what the kernel's cp.async zero-fill stages."""
    b, _, cin = x.shape
    h, w = hw
    pad = (ksize - 1) // 2
    oy, ox = f // ksize - pad, f % ksize - pad
    xi = torch.zeros((b, h + 2 * pad, w + 2 * pad, U.BK), dtype=x.dtype)
    chans = x.reshape(b, h, w, cin)[..., c0:c0 + U.BK]
    xi[:, pad:pad + h, pad:pad + w, : chans.shape[-1]] = chans
    rows = xi[:, pad + oy: pad + oy + h: stride, pad + ox: pad + ox + w: stride]
    return rows.reshape(-1, U.BK)


@pytest.mark.parametrize("stride", [1, 2])
def test_split_k_stages_add_up_to_the_conv(stride):
    """Emulate the kernel's split-K blocking from the plan: part p sums the
    ring stages [kt0, kt1) of the kernel's formula, stage kt being tap
    kt // chunks and channels (kt % chunks) * BK onwards, zero-filled off
    the image and past Cin; the parts, added in ascending order with the
    bias, equal the plain conv within 2e-5."""
    rng = np.random.default_rng(5 + stride)
    b, side, cin, cout, ksize = 1, 8, 40, 24, 3
    x = _t(rng.normal(size=(b, side * side, cin)))
    w = _t(rng.normal(size=(ksize * ksize, cin, cout)) * (9 * cin) ** -0.5)
    bias = _t(rng.normal(size=(cout,)))
    m = b * (-(-side // stride)) ** 2
    plan = U.tile_plan(m, cout, cin, ksize)
    assert plan.split > 1
    w_pad, _ = U.prepare_weights(w, plan.bn)  # hi only: the blocking is the point
    chunks = plan.stages // (ksize * ksize)
    total = None
    for part in range(plan.split):
        lo, hi = _split_range(plan.stages, plan.split, part)
        acc = torch.zeros((m, w_pad.shape[1]))
        for kt in range(lo, hi):
            f, c0 = kt // chunks, (kt % chunks) * U.BK
            stage = _im2col_stage(x, (side, side), ksize, stride, f, c0)
            acc += stage @ w_pad[f, :, c0:c0 + U.BK].T
        total = acc[:, :cout] if total is None else total + acc[:, :cout]
    want = U.uniconv_apply(U.tf32_round(w), bias, x, (side, side), ksize, stride)
    assert _rel_err((total + bias).reshape(want.shape), want) <= TOL_CONV
