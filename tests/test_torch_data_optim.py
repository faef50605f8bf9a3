"""The port's data pipeline and AdamW against the JAX package's.

* ``latent_batch`` / ``token_batch``: bitwise, for several (seed, step,
  process_index, process_count); the ``Prefetcher`` yields steps in order;
* ``lr_schedule`` over every step of three schedules: within 4 float32
  steps of the value (rtol 2**-21: XLA's cosine and torch's differ in
  the last bits; measured 2.2e-7 on 3 of 103 steps, equal elsewhere);
* ``global_norm`` within 1e-6 relative (the sums may run in another
  order; measured: equal);
* five ``adamw_update`` steps on a bridged random tree, gradients large
  enough that the clip acts (global norms 9.1-13.8): parameters, m and v
  within 1e-6 relative to each leaf's largest value (measured: equal), the
  step equal;
* ``compress_decompress``: dequantized gradient and residual bitwise, the
  port's int8 codes and scale reproduce the reference's dequantized values
  bitwise, half-way codes round to even; ``compressed_grads`` bitwise on a
  tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.data import pipeline as TP
from repro_torch.optim import adamw as TA

BATCH_CASES = [(0, 0, 0, 1), (3, 17, 0, 1), (3, 17, 1, 2), (11, 5, 3, 4)]


@pytest.mark.parametrize("seed,step,pi,pc", BATCH_CASES)
def test_batches_bitwise(seed, step, pi, pc):
    jc = JP.DataConfig(global_batch=8, seq_len=33, vocab_size=50, seed=seed, process_index=pi,
                       process_count=pc)
    tc = TP.DataConfig(global_batch=8, seq_len=33, vocab_size=50, seed=seed, process_index=pi,
                       process_count=pc)
    for got, ref in ((TP.token_batch(tc, step), JP.token_batch(jc, step)),
                     (TP.latent_batch(tc, step, size=16), JP.latent_batch(jc, step, size=16))):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])


def test_prefetcher_orders_steps():
    cfg = TP.DataConfig(global_batch=2, seq_len=0, vocab_size=8)
    jcfg = JP.DataConfig(global_batch=2, seq_len=0, vocab_size=8)
    pre = TP.Prefetcher(lambda s: TP.latent_batch(cfg, s, size=8), start_step=3)
    try:
        got = [next(pre) for _ in range(4)]
    finally:
        pre.close()
    assert not pre._thread.is_alive()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, b in got:
        np.testing.assert_array_equal(b["latents"], JP.latent_batch(jcfg, s, size=8)["latents"])


@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=2e-4, warmup_steps=0, total_steps=13),
    dict(lr=3e-4, warmup_steps=21, total_steps=300),
])
def test_lr_schedule_matches(cfg):
    jc, tc = JA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    steps = range(cfg["total_steps"] + 3)
    ref = np.array([np.asarray(JA.lr_schedule(jc, jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([TA.lr_schedule(tc, torch.tensor(s, dtype=torch.int32)).numpy()
                    for s in steps])
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2.0**-21, atol=0)


def _tree(rng, scale=1.0):
    return {
        "a": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
        "b": [(rng.normal(size=(5,)) * scale).astype(np.float32),
              {"c": (rng.normal(size=(2, 3, 2)) * scale).astype(np.float32)}],
        "z": (rng.normal(size=(7,)) * scale).astype(np.float32),
    }


def _close(got, ref, rtol):
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        assert np.abs(g - r).max() <= rtol * max(np.abs(r).max(), 1e-30), (g, r)


def test_global_norm_matches():
    tree = _tree(np.random.default_rng(0), scale=3.0)
    ref = np.asarray(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = TA.global_norm(bridge.tree_to_torch(tree)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_adamw_update_five_steps():
    rng = np.random.default_rng(1)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1.0)
    jc, tc = JA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    p0 = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), bridge.tree_to_torch(p0)
    js, ts = JA.init_adamw(jp), TA.init_adamw(tp)
    for _ in range(5):
        g = _tree(rng, scale=2.0)  # global norm ~10: the clip acts
        jp, js = JA.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = TA.adamw_update(tc, tp, bridge.tree_to_torch(g), ts)
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for got, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        _close(bridge.tree_to_numpy(got), ref, 1e-6)


@pytest.mark.parametrize("case", ["normal", "with_error", "zeros", "half_way"])
def test_compress_decompress_bitwise(case):
    rng = np.random.default_rng(2)
    g = rng.normal(size=(257,)).astype(np.float32)
    err = np.zeros_like(g)
    if case == "with_error":
        err = (rng.normal(size=g.shape) * 0.01).astype(np.float32)
    elif case == "zeros":
        g = np.zeros_like(g)
    elif case == "half_way":  # scale 1: codes of x.5 round half to even
        g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0], np.float32)
        err = np.zeros_like(g)
    deq_r, err_r = (np.asarray(a) for a in JA.compress_decompress(jnp.asarray(g), jnp.asarray(err)))
    deq, new_err = TA.compress_decompress(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(deq.numpy(), deq_r)
    np.testing.assert_array_equal(new_err.numpy(), err_r)
    q, scale = TA.quantize_int8(torch.from_numpy(g) + torch.from_numpy(err))
    assert q.dtype == torch.int8
    assert scale.numpy() == np.maximum(np.abs(g + err).max(), np.float32(1e-12)) / np.float32(127)
    np.testing.assert_array_equal((q.float() * scale).numpy(), deq_r)
    if case == "half_way":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 3]


def test_compressed_grads_tree_bitwise():
    rng = np.random.default_rng(3)
    g, e = _tree(rng), _tree(rng, scale=0.01)
    jg, jstate = JA.compressed_grads(jax.tree.map(jnp.asarray, g),
                                     JA.CompressionState(jax.tree.map(jnp.asarray, e)))
    tg, tstate = TA.compressed_grads(bridge.tree_to_torch(g),
                                     TA.CompressionState(bridge.tree_to_torch(e)))
    for got, ref in ((tg, jg), (tstate.error, jstate.error)):
        for a, b in zip(jax.tree.leaves(bridge.tree_to_numpy(got)), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert isinstance(tstate, TA.CompressionState)
