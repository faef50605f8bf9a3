"""The port's checkpoint manager: the six cases of ``tests/test_checkpoint.py``
on a tree of tensors, and checkpoints that cross between the two packages.

A checkpoint of ``{"params", "opt"}`` (an sd_toy U-Net and its AdamW state)
written by ``repro`` restores in the port, and one written by the port
restores in ``repro``, bitwise, with the same flat key strings in the npz
(the ones ``jax.tree_util.keystr`` writes, e.g. ``['opt'].m['conv_in']['w']``).
The bfloat16 case holds a bf16 ``repro`` tree against the port's float32
tensors that hold the same values.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_unet_config as j_get_unet_config
from repro.models import unet as JU
from repro.optim import init_adamw as j_init_adamw
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.optim import init_adamw
from test_torch_unet import _numpy_tree

JTOY = j_get_unet_config("sd_toy")


@pytest.fixture()
def tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4, dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": [{"x": torch.zeros(2, 2)}],
    }


def _fill(tree, value):
    return tree_map(lambda t: torch.full_like(t, value), tree)


def test_roundtrip(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(10, tree)
    got = cm.restore(10, tree)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_restore_latest_picks_newest(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _fill(tree, 1))
    cm.save(2, _fill(tree, 2))
    step, got = cm.restore_latest(tree)
    assert step == 2
    assert float(tree_leaves(got)[0].ravel()[0]) == 2.0


def test_keep_k_gc(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        cm.save(s, tree)
    assert cm.list_steps() == [3, 4]


def test_uncommitted_checkpoint_ignored(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000002"))  # torn: no COMMIT
    assert cm.list_steps() == [1]
    step, _ = cm.restore_latest(tree)
    assert step == 1


def test_torn_shard_falls_back(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, tree)
    cm.save(2, tree)
    os.remove(os.path.join(str(tmp_path), "step_00000002", "host00.npz"))
    step, _ = cm.restore_latest(tree)
    assert step == 1


def test_empty_dir_returns_none(tmp_path, tree):
    assert CheckpointManager(str(tmp_path)).restore_latest(tree) is None


def test_numpy_leaves_restore_as_numpy(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, {"x": np.arange(4, dtype=np.int64)})
    got = cm.restore(3, {"x": np.zeros(4, np.int64)})["x"]
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.arange(4))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jstate(request):
    """{"params", "opt"} of ``repro`` at sd_toy, moments filled with noise."""
    cfg = dataclasses.replace(JTOY, dtype=request.param)
    specs = jax.eval_shape(lambda k: JU.init_unet(k, cfg), jax.random.key(0))
    params = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                          _numpy_tree(lambda k: JU.init_unet(k, cfg), seed=0), specs)
    opt = j_init_adamw(params)
    rng = np.random.default_rng(4)
    noisy = lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32))  # noqa: E731
    opt = opt._replace(step=jnp.asarray(9, jnp.int32), m=jax.tree.map(noisy, opt.m),
                       v=jax.tree.map(noisy, opt.v))
    return {"params": params, "opt": opt}


def _port_template(jstate):
    params = tree_map(torch.zeros_like, bridge.tree_to_torch(jax.tree.map(np.asarray,
                                                                          jstate["params"])))
    return {"params": params, "opt": init_adamw(params)}


def _npz_keys(root, step):
    with np.load(os.path.join(root, f"step_{step:08d}", "host00.npz")) as z:
        return sorted(z.files)


def _jax_keys(tree):
    return sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


def test_repro_checkpoint_restores_in_the_port(tmp_path, jstate):
    JCheckpointManager(str(tmp_path)).save(9, jstate)
    template = _port_template(jstate)
    keys = sorted(k for k, _ in tree_leaves_with_path(template))
    assert keys == _npz_keys(str(tmp_path), 9) == _jax_keys(jstate)
    assert "['opt'].m['conv_in']['w']" in keys and "['opt'].step" in keys
    step, got = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 9 and got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 9
    ref = jax.tree.leaves(jstate)
    for (key, a), b in zip(tree_leaves_with_path(got), ref):
        assert a.dtype == (torch.int32 if key == "['opt'].step" else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype), key)


def test_port_checkpoint_restores_in_repro(tmp_path, jstate):
    live = bridge.tree_to_torch(jax.tree.map(np.asarray, jstate))
    CheckpointManager(str(tmp_path)).save(9, live)
    assert _npz_keys(str(tmp_path), 9) == _jax_keys(jstate)
    template = jax.tree.map(jnp.zeros_like, jstate)
    step, got = JCheckpointManager(str(tmp_path)).restore_latest(template)
    assert step == 9
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      np.asarray(b).astype(np.float32))
