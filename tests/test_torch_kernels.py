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
from repro_torch.kernels.stream_norm.ops import stream_group_norm, stream_group_norm_plain
from repro_torch.kernels.uniconv.ops import uniconv, uniconv_apply
from repro_torch.models.backend import resolve_backend

#: (L, C) of every sd_toy U-Net level (16x16 latent, channel mults 1/2/4)
SERVED_LC = [(256, 32), (64, 64), (16, 128)]
#: levels that run attention (attn_levels = (0, 1)); 2 heads; ctx_len 8
ATTN_LC = [(256, 32), (64, 64)]
GROUPS = 8


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
    and the ragged cases (Cin=4, Cout=3, stride 2, KV tail 77, Dh=40)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)  # noqa: E731
    for b, side, cin, cout, k, stride in [
        (2, 16, 32, 64, 3, 1), (2, 16, 4, 32, 3, 1), (1, 16, 32, 3, 3, 1), (2, 16, 64, 64, 3, 2),
        (2, 4, 128, 128, 1, 1),
    ]:
        x, w, bias = r(b, side * side, cin), r(k * k, cin, cout) * 0.1, r(cout)
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
    ]:
        q, k, v = r(b, h, sq, dh), r(b, hkv, skv, dh), r(b, hkv, skv, dh)
        torch.testing.assert_close(
            flash_attention(q, k, v, **opts), flash_attention_ref(q, k, v, **opts),
            atol=1e-4, rtol=1e-4,
        )
