"""Kernel modules of repro_torch against the JAX reference, on the CPU.

Each kernel wrapper takes its plain PyTorch version for a CPU tensor, so
here both the wrappers and the ``"eager"``/``"cuda"`` backends run the plain
versions; the reference is the JAX package's XLA path
(``resolve_backend("xla")``, ``kernels/*/ref.py``).  Shapes are the served
``sd_toy`` levels.  Tolerances: 2e-5 per conv and group norm (measured:
conv bit-equal, group norm 3.3e-6), 1e-4 for attention (measured 6e-7).
The CUDA kernels themselves run only on a GPU:
``test_cuda_kernels_match_plain`` holds them against the plain versions
there and skips here.  The JAX reference is imported inside a fixture, so
on a GPU host without JAX this module still runs the CUDA test
(``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
from repro_torch.kernels.fused_matmul.ops import fused_matmul, fused_matmul_plain
from repro_torch.kernels.stream_norm.ops import (
    stream_group_norm,
    stream_group_norm_plain,
    stream_norm,
    stream_norm_plain,
)
from repro_torch.kernels.uniconv.ops import tile_plan, uniconv, uniconv_apply
from repro_torch.models.backend import resolve_backend

#: (L, C) of every sd_toy U-Net level (16x16 latent, channel mults 1/2/4)
SERVED_LC = [(256, 32), (64, 64), (16, 128)]
#: levels that run attention (attn_levels = (0, 1)); 2 heads; ctx_len 8
ATTN_LC = [(256, 32), (64, 64)]
GROUPS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the CPU, and torch's
    spinning thread pool slows a crowded worker many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hw(length: int) -> tuple[int, int]:
    side = int(round(length**0.5))
    return side, side


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's XLA backend and flash-attention oracle."""
    jnp = pytest.importorskip("jax.numpy", reason="the JAX reference is not installed")
    from repro.kernels.flash_attention.ref import flash_attention_ref as flash_ref
    from repro.models.backend import resolve_backend as j_resolve

    return types.SimpleNamespace(jnp=jnp, xla=j_resolve("xla"), flash_ref=flash_ref)


@pytest.mark.parametrize("l,c", SERVED_LC)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ksize", [1, 3])
def test_uniconv_matches_xla(ref, l, c, stride, ksize):
    rng = np.random.default_rng(10 * l + c + ksize + 100 * stride)
    w = rng.normal(size=(ksize * ksize, c, 2 * c)).astype(np.float32) * 0.05
    b = rng.normal(size=(2 * c,)).astype(np.float32)
    x = rng.normal(size=(2, l, c)).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(
        ref.xla.conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x), _hw(l), ksize, stride)
    )
    plain = uniconv_apply(_t(w), _t(b), _t(x), _hw(l), ksize, stride)
    wrapped = uniconv(_t(x), _t(w), _t(b), _hw(l), ksize, stride)
    assert plain.shape == want.shape
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


@pytest.mark.parametrize("l,c", SERVED_LC)
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_xla(ref, l, c, silu):
    rng = np.random.default_rng(20 * l + c + silu)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    x = (rng.normal(size=(2, l, c)) + 0.5).astype(np.float32)
    jnp = ref.jnp
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want = np.asarray(ref.xla.group_norm(jnp.asarray(x), p, GROUPS, silu=silu))
    for name in ("eager", "cuda"):
        got = resolve_backend(name).group_norm(
            _t(x), {"scale": _t(scale), "bias": _t(bias)}, GROUPS, silu=silu
        )
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=name)
    wrapped = stream_group_norm(_t(x), _t(scale), _t(bias), groups=GROUPS, silu=silu)
    plain = stream_group_norm_plain(_t(x), _t(scale), _t(bias), groups=GROUPS, silu=silu)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


@pytest.mark.parametrize("backend", ["eager", "cuda"])
@pytest.mark.parametrize("l,c", ATTN_LC)
@pytest.mark.parametrize("lkv", [None, 8])  # None = self-attention, 8 = ctx_len
def test_attention_matches_mha(ref, backend, l, c, lkv):
    """The eager backend is ``_mha``; the cuda backend splits heads around
    ``flash_attention`` (its plain version on the CPU)."""
    rng = np.random.default_rng(30 * l + c + (lkv or 0))
    lk = l if lkv is None else lkv
    q = rng.normal(size=(2, l, c)).astype(np.float32)
    k = rng.normal(size=(2, lk, c)).astype(np.float32)
    v = rng.normal(size=(2, lk, c)).astype(np.float32)
    o = (rng.normal(size=(c, c)) * c**-0.5).astype(np.float32)
    want = np.asarray(ref.xla.attention(*(ref.jnp.asarray(a) for a in (q, k, v, o)), 2))
    got = resolve_backend(backend).attention(_t(q), _t(k), _t(v), _t(o), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "opts,hkv",
    [
        (dict(causal=True), 4),
        (dict(causal=True, window=5), 4),
        (dict(causal=False, softcap=2.0), 4),
        (dict(causal=True), 2),  # grouped-query: 4 query heads over 2 KV heads
    ],
    ids=["causal", "window", "softcap", "gqa"],
)
def test_flash_attention_options_match_ref(ref, opts, hkv):
    rng = np.random.default_rng(40 + hkv + len(opts))
    q = rng.normal(size=(2, 4, 24, 16)).astype(np.float32)
    k = rng.normal(size=(2, hkv, 24, 16)).astype(np.float32)
    v = rng.normal(size=(2, hkv, 24, 16)).astype(np.float32)
    jnp = ref.jnp
    want = np.asarray(ref.flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **opts))
    plain = flash_attention_ref(_t(q), _t(k), _t(v), **opts)
    wrapped = flash_attention(_t(q), _t(k), _t(v), **opts)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """Each kernel against its plain version on the card, at sd_toy shapes
    and the ragged cases (Cin=4, Cout=3, stride 2, KV tail 77, Dh=40; row
    norm D=33 and rows wider than the shared-memory cache; product
    (96, 160, 224)), float32 and bfloat16.  A bfloat16 output may differ by
    one bfloat16 step (rtol 2**-7) where the float32 sums differ in order.
    The shapes the tensor-core designs branch on: uniconv's split-K
    (sd_v14 level 3, 8x8 at 1280 channels, 3x3 and 1x1), the 160-wide N
    tile (Cout 320), Cout 3 and 4, Cin 4, Cin 6 (4-byte copies), stride 2;
    flash attention's Dh 40/80/160, Skv 77, causal, window, softcap, GQA."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)  # noqa: E731
    for b, side, cin, cout, k, stride in [
        (2, 16, 32, 64, 3, 1), (2, 16, 4, 32, 3, 1), (1, 16, 32, 3, 3, 1), (2, 16, 64, 64, 3, 2),
        (2, 4, 128, 128, 1, 1),
        (4, 8, 1280, 1280, 3, 1), (4, 8, 2560, 1280, 1, 1), (2, 16, 320, 320, 3, 1),
        (2, 16, 320, 4, 3, 1), (1, 16, 6, 16, 3, 1), (4, 16, 640, 640, 3, 2),
    ]:
        scale = 0.1 if k * k * cin <= 1152 else (k * k * cin) ** -0.5
        x, w, bias = r(b, side * side, cin), r(k * k, cin, cout) * scale, r(cout)
        got = uniconv(x, w, bias, (side, side), k, stride)
        ref = uniconv_apply(w, bias, x, (side, side), k, stride)
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    for b, l, c, g in [(2, 256, 32, 8), (2, 64, 320, 32), (1, 1000, 64, 8)]:
        x, sc, bi = r(b, l, c) + 0.5, r(c), r(c)
        for silu in (False, True):
            torch.testing.assert_close(
                stream_group_norm(x, sc, bi, groups=g, silu=silu),
                stream_group_norm_plain(x, sc, bi, groups=g, silu=silu),
                atol=2e-5, rtol=2e-5,
            )
    for (b, h, sq, skv, dh, hkv), opts in [
        ((2, 2, 256, 256, 16, 2), dict(causal=False)),
        ((2, 8, 130, 77, 40, 8), dict(causal=False)),
        ((2, 4, 100, 100, 32, 2), dict(causal=True, window=9, softcap=3.0)),
        ((2, 2, 130, 130, 80, 2), dict(causal=False)),
        ((2, 2, 100, 77, 160, 2), dict(causal=False)),
        ((1, 2, 70, 64, 160, 2), dict(causal=False)),
        ((2, 4, 200, 200, 40, 4), dict(causal=True)),
        ((2, 4, 200, 200, 40, 4), dict(causal=True, window=37)),
        ((2, 4, 200, 200, 40, 4), dict(causal=False, softcap=5.0)),
        ((2, 4, 200, 200, 40, 2), dict(causal=True)),
        ((1, 2, 70, 90, 30, 1), dict(causal=False)),
    ]:
        q, k, v = r(b, h, sq, dh), r(b, hkv, skv, dh), r(b, hkv, skv, dh)
        torch.testing.assert_close(
            flash_attention(q, k, v, **opts), flash_attention_ref(q, k, v, **opts),
            atol=1e-4, rtol=1e-4,
        )
    bf16 = torch.bfloat16
    for shape, dtype in [
        ((2, 64, 320), torch.float32), ((100, 33), torch.float32), ((3, 12301), torch.float32),
        ((2, 16384), torch.float32), ((64, 320), bf16), ((100, 33), bf16),
    ]:
        d = shape[-1]
        x, sc, bi = (r(*shape) * 2 + 0.5).to(dtype), r(d), r(d)
        for mode, eps in (("layernorm", 1e-5), ("rmsnorm", 1e-6)):
            for bias in (bi, None):
                got = stream_norm(x, sc, bias, mode=mode, eps=eps)
                ref = stream_norm_plain(x, sc, bias, mode=mode, eps=eps)
                assert got.dtype == dtype and got.shape == shape
                torch.testing.assert_close(
                    got.float(), ref.float(), atol=2e-5, rtol=2e-5 if dtype != bf16 else 2**-7,
                )
    for (m, k, n), dtype in [
        ((128, 256, 64), torch.float32), ((96, 160, 224), torch.float32),
        ((128, 320, 192), bf16), ((96, 160, 224), bf16),
    ]:
        a, b, bias = r(m, k).to(dtype), (r(k, n) * k**-0.5).to(dtype), r(n).to(dtype)
        for epilogue in ("none", "bias", "gelu", "silu"):
            got, stats = fused_matmul(a, b, bias, epilogue=epilogue, with_stats=True)
            ref, ref_stats = fused_matmul_plain(a, b, bias, epilogue=epilogue, with_stats=True)
            assert got.dtype == dtype and stats.dtype == torch.float32
            torch.testing.assert_close(
                got.float(), ref.float(), atol=1e-4, rtol=1e-4 if dtype != bf16 else 2**-7,
            )
            torch.testing.assert_close(stats, ref_stats, rtol=1e-4, atol=1e-3)
        plain_only, no_stats = fused_matmul(a, b, bias)  # "none" ignores the bias
        assert no_stats is None
        torch.testing.assert_close(plain_only.float(), fused_matmul_plain(a, b)[0].float(),
                                   atol=1e-4, rtol=1e-4 if dtype != bf16 else 2**-7)


@pytest.mark.cuda
def test_cuda_unaligned_operands_and_repeatable_split_k(cuda_device):
    """Contiguous views that start one float past a 16-byte boundary take
    the kernels' 4-byte copies (their 16-byte cp.async would fault) and
    agree with the plain versions; a split-K conv (sd_v14 level 3) gives
    the same bits on every run, its partials summed in a fixed order."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)  # noqa: E731

    def unaligned(*shape):
        n = int(np.prod(shape))
        t = r(n + 1)[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 == 4
        return t

    x, w, bias = unaligned(2, 64, 320), r(9, 320, 320) * (9 * 320) ** -0.5, r(320)
    torch.testing.assert_close(uniconv(x, w, bias, (8, 8), 3),
                               uniconv_apply(w, bias, x, (8, 8), 3), atol=2e-5, rtol=2e-5)
    q, k, v = unaligned(2, 4, 130, 40), unaligned(2, 4, 77, 40), unaligned(2, 4, 77, 40)
    torch.testing.assert_close(flash_attention(q, k, v, causal=False),
                               flash_attention_ref(q, k, v, causal=False), atol=1e-4, rtol=1e-4)
    x, w, bias = r(4, 64, 1280), r(9, 1280, 1280) * (9 * 1280) ** -0.5, r(1280)
    assert tile_plan(4 * 64, 1280, 1280, 3).split > 1
    first = uniconv(x, w, bias, (8, 8), 3)
    for _ in range(3):
        assert torch.equal(uniconv(x, w, bias, (8, 8), 3), first)


@pytest.mark.cuda
def test_cuda_flash_error_does_not_grow_with_keys(cuda_device):
    """Over 4,096 keys with flat logits (std 1, so every key weighs) the
    kernel stays within 1e-5 of float64 at each served head width: each KV
    tile's P V is folded into the output with float32 FMAs.  Summed in the
    mma's accumulator across all tiles it read 2.5e-5 to 4.0e-5 (cuBLAS
    float32 1.9e-6 to 2.3e-6)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for dh in (40, 64, 80, 160):
        q, k, v = (torch.randn(2, 4, s, dh, generator=gen, device=cuda_device)
                   for s in (256, 4096, 4096))
        want = flash_attention_ref(q.double(), k.double(), v.double(), causal=False)
        got = flash_attention(q, k, v, causal=False).double()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5, (dh, err)


@pytest.mark.cuda
def test_cuda_group_norm_and_fused_matmul_redesign(cuda_device):
    """The one-launch cluster group norm and the tensor-core fused_matmul
    against their plain versions, each result the same bits over 4 runs.

    Group norm: level 3 [4, 64, 2560], level 0 [4, 4096, 960], the VAE's
    [1, 65536, 32] with 8 groups (a 16-block cluster), an odd C/G
    ([2, 100, 36], G 4) and a view one float off a 16-byte boundary
    (4-byte copies), with and without SiLU; tolerance 2e-5.
    fused_matmul: every epilogue with and without stats, float32 (3xTF32
    wgmma, both N tiles) and bfloat16 (wgmma) on grids of at least 32
    tiles, and the SIMT tile of small products; ragged M, N and K, K and N
    off the 16-byte copies, and
    unaligned views.  Tolerances as chip_smoke.py: 1e-4 (float32), one
    bfloat16 step (rtol 2**-7), stats rtol 1e-4 / atol 1e-3."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)  # noqa: E731

    def unaligned(t):
        """t copied into a view that starts one element past a 16-byte boundary"""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    def same_bits(fn):
        first = fn()
        for _ in range(3):
            again = fn()
            for x, y in zip(first, again):
                assert y is None if x is None else torch.equal(x, y)
        return first

    for shape, g, off in [
        ((4, 64, 2560), 32, False), ((4, 4096, 960), 32, False), ((1, 65536, 32), 8, False),
        ((2, 100, 36), 4, False), ((2, 64, 320), 32, True),
    ]:
        x = r(*shape) + 0.5
        x = unaligned(x) if off else x
        sc, bi = r(shape[2]), r(shape[2])
        for silu in (False, True):
            (got,) = same_bits(lambda: (stream_group_norm(x, sc, bi, groups=g, silu=silu),))
            torch.testing.assert_close(
                got, stream_group_norm_plain(x, sc, bi, groups=g, silu=silu),
                atol=2e-5, rtol=2e-5,
            )
    bf16 = torch.bfloat16
    for (m, k, n), dtype, off in [
        ((4100, 1280, 320), torch.float32, False), ((2100, 320, 2600), torch.float32, False),
        ((1030, 101, 1302), torch.float32, False), ((2100, 96, 1300), torch.float32, True),
        ((96, 160, 224), torch.float32, False), ((77, 101, 130), torch.float32, False),
        ((4, 320, 1280), torch.float32, False),
        ((4096, 320, 1280), bf16, False), ((2000, 160, 1000), bf16, False),
        ((1030, 100, 1304), bf16, False), ((2100, 96, 1300), bf16, True),
        ((96, 100, 224), bf16, False), ((4, 64, 96), bf16, False),
    ]:
        a, b = r(m, k).to(dtype), (r(k, n) * k**-0.5).to(dtype)
        if off:
            a, b = unaligned(a), unaligned(b)
        bias = r(n)
        rtol = 1e-4 if dtype == torch.float32 else 2**-7
        for epilogue in ("none", "bias", "gelu", "silu"):
            for with_stats in (False, True):
                got, stats = same_bits(lambda: fused_matmul(
                    a, b, bias, epilogue=epilogue, with_stats=with_stats))
                ref, ref_stats = fused_matmul_plain(a, b, bias, epilogue=epilogue,
                                                    with_stats=with_stats)
                assert got.dtype == dtype
                torch.testing.assert_close(got.float(), ref.float(), atol=1e-4, rtol=rtol)
                if with_stats:
                    torch.testing.assert_close(stats, ref_stats, rtol=1e-4, atol=1e-3)
                else:
                    assert stats is None
