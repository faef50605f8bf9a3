"""The port's U-Net and VAE decoder against the JAX package's, on bridged
sd_toy weights.

The weights fill ``repro``'s own parameter trees (``init_unet``/``init_vae``
structure and shapes) with numbers made from a seed with numpy, including
non-zero biases and non-unit norm scales, and cross through
``repro_torch.bridge``; inputs are made the same way.  The
full forward and every partial entry step (fed the JAX run's captured entry
feature) agree within 2e-4 absolute (measured: eps 2.5e-6 on values up to 2.1,
captured features 1.1e-5); the decoded image within 2e-4 (measured 3.1e-6
on values up to 4.5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_unet_config as j_get_unet_config
from repro.models import unet as JU
from repro.models import vae as JV
from repro_torch import bridge
from repro_torch.configs import get_unet_config
from repro_torch.models import unet as TU
from repro_torch.models import vae as TV

JTOY = j_get_unet_config("sd_toy")
TOY = get_unet_config("sd_toy")
N_UP = TU.n_up_steps(TOY)
ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """sd_toy tensors are small: one intra-op thread keeps this module from
    crowding the other test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _numpy_tree(init, seed: int):
    """The JAX tree of ``init`` (shapes only), filled from numpy: dense and
    conv weights at 1/sqrt(fan in), norm scales near 1, biases near 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        shape = spec.shape
        if len(shape) == 1:
            base = 1.0 if getattr(path[-1], "key", "") == "scale" else 0.0
            return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)
        fan_in = shape[-2] * (shape[0] if len(shape) == 3 else 1)
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.key(0)))


@pytest.fixture(scope="module")
def weights():
    tree = _numpy_tree(lambda k: JU.init_unet(k, JTOY), seed=0)
    return jax.tree_util.tree_map(jnp.asarray, tree), bridge.unet_params_from_numpy(tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, TOY.latent_size**2, TOY.in_channels)).astype(np.float32)
    t = np.array([981, 421], np.int32)
    ctx = (rng.normal(size=(2, TOY.ctx_len, TOY.ctx_dim)) * 0.2).astype(np.float32)
    return x, t, ctx


@pytest.fixture(scope="module")
def jax_full(weights, inputs):
    x, t, ctx = inputs
    full = jax.jit(lambda p, *a: JU.unet_apply(JTOY, p, *a, capture_steps=tuple(range(N_UP))))
    return full(weights[0], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))


#: the port's UNetConfig fields the JAX package's lacks, at the values that
#: keep a config the JAX package's (sdxl_base sets them)
PORT_ONLY = dict(tf_depths=None, head_dim=None, pooled_dim=0, n_time_ids=0, time_id_dim=0)


def test_config_and_plans_match():
    assert TOY == get_unet_config("sd_toy")
    for name in ("sd_toy", "sd_v14", "sd_xl"):
        jc, tc = j_get_unet_config(name), get_unet_config(name)
        assert {f: getattr(tc, f) for f in jc.__dataclass_fields__} == {
            f: getattr(jc, f) for f in jc.__dataclass_fields__
        }
        assert set(tc.__dataclass_fields__) == set(jc.__dataclass_fields__) | set(PORT_ONLY)
        assert {f: getattr(tc, f) for f in PORT_ONLY} == PORT_ONLY
        assert TU._down_plan(tc) == JU._down_plan(jc)
        assert TU._up_plan(tc) == JU._up_plan(jc)


def test_init_unet_builds_the_jax_tree():
    """The port's own init has the JAX tree's structure, shapes and scales."""
    ours = TU.init_unet(TOY, torch.Generator().manual_seed(0))
    jleaves, jdef = jax.tree_util.tree_flatten(
        jax.eval_shape(lambda k: JU.init_unet(k, JTOY), jax.random.key(0))
    )
    tleaves, tdef = jax.tree_util.tree_flatten(ours)
    assert tdef == jdef
    for spec, ours_leaf in zip(jleaves, tleaves):
        shape = spec.shape
        assert tuple(ours_leaf.shape) == shape
        if len(shape) > 1:  # JAX draws N(0, 1/fan_in); norms and biases are 1 and 0
            fan_in = shape[-2] * (shape[0] if len(shape) == 3 else 1)
            assert abs(float(ours_leaf.std()) * fan_in**0.5 - 1.0) < 0.25


@pytest.mark.parametrize("entry_step", range(N_UP))
def test_unet_apply_matches_jax(weights, inputs, jax_full, entry_step):
    x, t, ctx = inputs
    jparams, tparams = weights
    if entry_step == 0:
        jeps, jcap = jax_full
        teps, tcap = TU.unet_apply(
            TOY, tparams, torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(ctx), capture_steps=tuple(range(N_UP)),
        )
        assert sorted(tcap) == sorted(jcap)
        for s in jcap:
            np.testing.assert_allclose(tcap[s].numpy(), np.asarray(jcap[s]), atol=ATOL, rtol=0)
    else:
        feat = np.array(jax_full[1][entry_step])
        part = jax.jit(
            lambda p, f, *a: JU.unet_apply(JTOY, p, *a, entry_step=entry_step, entry_feat=f)
        )
        jeps, _ = part(jparams, jnp.asarray(feat), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        teps, _ = TU.unet_apply(
            TOY, tparams, torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(ctx), entry_step=entry_step, entry_feat=torch.from_numpy(feat),
        )
    np.testing.assert_allclose(teps.numpy(), np.asarray(jeps), atol=ATOL, rtol=0)


def test_vae_decode_matches_jax():
    tree = _numpy_tree(lambda k: JV.init_vae(k, latent_channels=TOY.in_channels), seed=3)
    jvae, tvae = jax.tree_util.tree_map(jnp.asarray, tree), bridge.vae_params_from_numpy(tree)
    z = np.random.default_rng(8).normal(size=(1, 16 * 16, 4)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z: JV.vae_decode(p, z, (16, 16)))(jvae, jnp.asarray(z)))
    got = TV.vae_decode(tvae, torch.from_numpy(z), (16, 16))
    assert got.shape == (1, 64 * 64, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
