"""The port's KERNEL_REGISTRY and its two off-path kernels against the JAX package.

``stream_norm`` and ``fused_matmul`` sit on no served path of either package;
they are reached through ``KERNEL_REGISTRY``.  Here, on the CPU, each wrapper
takes its plain version, and the plain versions are held against the JAX
package: ``stream_norm_plain`` against ``stream_norm_ref`` (two-pass
variance) and, at one shape per mode, the Pallas ``stream_norm`` in interpret
mode; ``fused_matmul_plain`` against the Pallas ``fused_matmul`` in
interpret mode.  Tolerances and measured headroom (largest gap seen):

* norm 2e-5 (measured 9.5e-7 against both the oracle and Pallas);
* product 2e-4 (measured 1.7e-6), stats rtol 1e-4 / atol 1e-3 (measured
  2.3e-5 absolute);
* bfloat16 product: one bfloat16 step, rtol 2**-7 (measured bit-equal;
  its float32 stats 3.8e-6).

The CUDA kernels run only on a GPU (``tests/test_torch_kernels.py::
test_cuda_kernels_match_plain``).  JAX is imported inside a fixture, so a
host without it skips these tests instead of failing to collect.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.fused_matmul.ops import fused_matmul, fused_matmul_plain
from repro_torch.kernels.stream_norm.ops import stream_norm, stream_norm_plain

#: the JAX package's stream_norm test shapes (M, D)
NORM_CASES = [(64, 128), (256, 384), (1024, 64), (8, 8), (100, 33)]
#: (M, K, N): an even shape and the ragged one of the JAX tests
MATMUL_CASES = [(128, 256, 64), (96, 160, 224)]
EPILOGUES = ["none", "bias", "gelu", "silu"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def jref():
    """The JAX package's oracles and Pallas wrappers (interpret mode here)."""
    jnp = pytest.importorskip("jax.numpy", reason="the JAX reference is not installed")
    import repro.kernels as RK
    from repro.kernels.fused_matmul.ops import fused_matmul as pallas_matmul
    from repro.kernels.stream_norm.ops import stream_norm as pallas_norm
    from repro.kernels.stream_norm.ref import stream_norm_ref

    return types.SimpleNamespace(
        jnp=jnp, registry=RK.KERNEL_REGISTRY, norm_ref=stream_norm_ref,
        pallas_norm=pallas_norm, pallas_matmul=pallas_matmul,
    )


def _norm_inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)
    scale = (rng.normal(size=(d,)) * 0.1 + 1).astype(np.float32)
    bias = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    return x, scale, bias


def _matmul_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.2).astype(np.float32)
    return a, b, bias


@pytest.mark.parametrize("m,d", NORM_CASES)
@pytest.mark.parametrize("mode", ["layernorm", "rmsnorm"])
def test_stream_norm_plain_matches_ref(jref, m, d, mode):
    x, scale, bias = _norm_inputs(m, d, m + d)
    jnp = jref.jnp
    want = np.asarray(jref.norm_ref(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                    mode=mode))
    got = stream_norm_plain(_t(x), _t(scale), _t(bias), mode=mode)
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["layernorm", "rmsnorm"])
def test_stream_norm_plain_matches_pallas(jref, mode):
    x, scale, bias = _norm_inputs(256, 384, 7)
    jnp = jref.jnp
    want = np.asarray(jref.pallas_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                       mode=mode))
    got = stream_norm_plain(_t(x), _t(scale), _t(bias), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("mode", ["layernorm", "rmsnorm"])
def test_stream_norm_plain_leading_batch_dims(jref, mode):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    scale = np.ones((32,), np.float32)
    jnp = jref.jnp
    want = np.asarray(jref.norm_ref(jnp.asarray(x), jnp.asarray(scale), None, mode=mode))
    got = stream_norm_plain(_t(x), _t(scale), None, mode=mode)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_stream_norm_plain_rmsnorm_ignores_bias_and_default_eps():
    x, scale, bias = _norm_inputs(16, 48, 11)
    with_bias = stream_norm_plain(_t(x), _t(scale), _t(bias), mode="rmsnorm")
    without = stream_norm_plain(_t(x), _t(scale), None, mode="rmsnorm")
    np.testing.assert_array_equal(with_bias.numpy(), without.numpy())
    explicit = stream_norm_plain(_t(x), _t(scale), None, mode="rmsnorm", eps=1e-6)
    np.testing.assert_array_equal(without.numpy(), explicit.numpy())


def test_stream_norm_plain_single_pass_identity():
    """The one-pass E[x^2] - mean^2 survives an offset of 100: zero mean and
    unit variance per row, as the JAX package's own test asks."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(128, 512)) + 100.0).astype(np.float32)
    y = stream_norm_plain(_t(x), torch.ones(512), torch.zeros(512)).numpy()
    np.testing.assert_allclose(y.mean(-1), 0.0, atol=1e-3)
    np.testing.assert_allclose(y.var(-1), 1.0, atol=1e-2)


def test_stream_norm_plain_bf16_keeps_dtype():
    x, scale, bias = _norm_inputs(32, 64, 12)
    xb = _t(x).to(torch.bfloat16)
    got = stream_norm_plain(xb, _t(scale), _t(bias))
    want = stream_norm_plain(xb.float(), _t(scale), _t(bias)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("m,k,n", MATMUL_CASES)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_fused_matmul_plain_matches_pallas(jref, m, k, n, epilogue):
    a, b, bias = _matmul_inputs(m, k, n, m + n)
    jnp = jref.jnp
    want, want_stats = jref.pallas_matmul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias), epilogue=epilogue, with_stats=True
    )
    got, stats = fused_matmul_plain(_t(a), _t(b), _t(bias), epilogue=epilogue, with_stats=True)
    assert got.shape == (m, n) and stats.shape == (2, m) and stats.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats), rtol=1e-4, atol=1e-3)


def test_fused_matmul_plain_bf16_matches_pallas(jref):
    a, b, bias = _matmul_inputs(128, 256, 64, 8)
    jnp = jref.jnp
    ja, jb, jbias = (jnp.asarray(v, jnp.bfloat16) for v in (a, b, bias))
    want, want_stats = jref.pallas_matmul(ja, jb, jbias, epilogue="gelu", with_stats=True)
    ta, tb, tbias = (_t(np.asarray(v, np.float32)).to(torch.bfloat16) for v in (ja, jb, jbias))
    got, stats = fused_matmul_plain(ta, tb, tbias, epilogue="gelu", with_stats=True)
    assert got.dtype == torch.bfloat16 and stats.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-6, rtol=2**-7)
    np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats), rtol=1e-4, atol=1e-3)


def test_fused_matmul_plain_none_ignores_bias():
    a, b, bias = _matmul_inputs(40, 24, 56, 9)
    with_bias, s1 = fused_matmul_plain(_t(a), _t(b), _t(bias), with_stats=True)
    without, s2 = fused_matmul_plain(_t(a), _t(b), None, with_stats=True)
    np.testing.assert_array_equal(with_bias.numpy(), without.numpy())
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())
    assert fused_matmul_plain(_t(a), _t(b))[1] is None


def test_registry_has_the_jax_names(jref):
    assert set(K.KERNEL_REGISTRY) == set(jref.registry)
    assert set(K.launch_counts()) == set(jref.registry)


def _registry_args(name):
    """CPU arguments for each registry pair, at small sd_toy-like widths."""
    rng = np.random.default_rng(len(name))
    r = lambda *s: _t(rng.normal(size=s).astype(np.float32))  # noqa: E731
    if name == "uniconv":
        return (r(2, 64, 8), r(9, 8, 16) * 0.1, r(16), (8, 8), 3, 2), {}
    if name == "flash_attention":
        return (r(2, 2, 24, 16), r(2, 2, 24, 16), r(2, 2, 24, 16)), dict(causal=True)
    if name == "stream_norm":
        return (r(3, 10, 40), r(40), r(40)), dict(mode="layernorm", eps=1e-5)
    if name == "stream_group_norm":
        return (r(2, 16, 32), r(32), r(32)), dict(groups=8, silu=True)
    return (r(20, 48), r(48, 36), r(36)), dict(epilogue="silu", with_stats=True)


@pytest.mark.parametrize("name", sorted(K.KERNEL_REGISTRY))
def test_registry_wrapper_equals_plain_on_cpu(name):
    kernel, plain = K.KERNEL_REGISTRY[name]
    args, kwargs = _registry_args(name)
    K.reset_launch_counts()
    got, want = kernel(*args, **kwargs), plain(*args, **kwargs)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert K.launch_counts()[name] == 0  # a CPU tensor launches no kernel


@pytest.mark.parametrize("call", [
    lambda: stream_norm(torch.ones(2, 4), torch.ones(4), mode="groupnorm"),
    lambda: fused_matmul(torch.ones(2, 4), torch.ones(4, 3), epilogue="relu"),
], ids=["stream_norm-mode", "fused_matmul-epilogue"])
def test_registry_wrappers_reject_unknown_options(call):
    with pytest.raises(ValueError):
        call()
