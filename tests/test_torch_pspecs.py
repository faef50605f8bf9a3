"""Every partition-spec function of the port against the reference's.

``lm_pspecs`` / ``cache_pspecs`` (transformer), ``xlstm_pspecs`` /
``state_pspecs``, ``hymba_pspecs`` / ``cache_pspecs`` (through each
family's adapter, ``launch/steps.py``) and ``opt_pspecs``, for all ten
archs x {smoke, full} x model size {1, 2, 16} x FSDP {"data", None}.  The
JAX ``PartitionSpec``, ``KVCache``, ``MLSTMState`` and ``HymbaCache`` are
not the port's classes, so trees are compared as flattened (key path,
spec tuple) lists.  Every leaf of the port's ``init`` on ``meta`` has a
spec of its rank.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from repro.configs import ARCH_IDS, get_lm_config
from repro.launch import steps as RS
from repro_torch.common.sharding import P, is_spec
from repro_torch.common.tree import tree_leaves_with_path
from repro_torch.configs import get_lm_config as port_config
from repro_torch.launch import steps as TS
from repro_torch.launch.specs import params_struct

MODEL_SIZES = (1, 2, 16)
FSDP = ("data", None)
VARIANTS = ("smoke", "full")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_flat(tree) -> list[tuple[str, tuple]]:
    """(keystr, leaf) pairs of a reference tree: a spec as its tuple, an
    array or ``ShapeDtypeStruct`` as (shape, dtype name)."""
    pairs, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, NamedSharding)))
    out = []
    for path, leaf in pairs:
        if isinstance(leaf, NamedSharding):
            leaf = leaf.spec
        out.append((jax.tree_util.keystr(path),
                    tuple(leaf) if isinstance(leaf, JP)
                    else (tuple(leaf.shape), str(leaf.dtype))))
    return out


def port_flat(tree) -> list[tuple[str, tuple]]:
    """:func:`jax_flat` of a port tree (``P`` leaves, or tensors)."""
    return [(path, tuple(leaf) if isinstance(leaf, P)
             else (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")))
            for path, leaf in tree_leaves_with_path(tree, is_leaf=is_spec)]


def _same(ref_fn, port_fn):
    """Both raise the reference's ValueError, or both give equal trees."""
    try:
        want = ref_fn()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            port_fn()
        return None
    got = port_fn()
    assert port_flat(got) == jax_flat(want)
    return want, got


def _pair(arch, variant, **moe):
    ref, port = get_lm_config(arch, variant), port_config(arch, variant)
    if moe:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe))
        port = dataclasses.replace(port, moe=dataclasses.replace(port.moe, **moe))
    return RS.get_adapter(ref), TS.get_adapter(port)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_pspecs_match_the_reference(arch, variant):
    ref, port = _pair(arch, variant)
    for ms in MODEL_SIZES:
        for fsdp in FSDP:
            both = _same(lambda: ref.pspecs(ms, fsdp), lambda: port.pspecs(ms, fsdp))
            if both is not None:
                assert port_flat(TS.opt_pspecs(both[1])) == jax_flat(RS.opt_pspecs(both[0]))
    assert port.takes_embeddings == ref.takes_embeddings


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_the_reference(arch, variant):
    ref, port = _pair(arch, variant)
    for ms in MODEL_SIZES:
        for ba in ((), ("data",), ("pod", "data")):
            for seq in (None, "data", "model"):
                assert (port_flat(port.cache_pspecs(ba, seq, ms))
                        == jax_flat(ref.cache_pspecs(ba, seq, ms))), (ms, ba, seq)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_expert_or_tensor_parallel_matches_the_reference(arch):
    """``auto`` picks EP where the experts divide the model axis, ``tp``
    forces TP, and ``ep`` raises the reference's ValueError where they do
    not divide."""
    for mode in ("auto", "tp", "ep"):
        ref, port = _pair(arch, "full", shard_mode=mode)
        for ms in MODEL_SIZES + (256,):
            if _same(lambda: ref.pspecs(ms, "data"), lambda: port.pspecs(ms, "data")) is None:
                assert mode == "ep", ms
    _, port = _pair("mixtral-8x22b", "full", shard_mode="ep")
    with pytest.raises(ValueError, match="EP requested but experts don't divide"):
        port.pspecs(16, "data")  # 8 experts over 16
    w_in = "['blocks']['slot0']['moe']['w_in']"
    ep = port_flat(_pair("qwen3-moe-235b-a22b", "full", shard_mode="auto")[1].pspecs(16, "data"))
    assert (w_in, (None, "model", "data", None)) in ep  # 128 experts over 16
    tp = port_flat(_pair("qwen3-moe-235b-a22b", "full")[1].pspecs(16, "data"))
    assert (w_in, (None, None, "data", "model")) in tp  # the config's "tp"


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_meta_leaf_has_a_spec_of_its_rank(arch, variant):
    """``init`` and ``init_cache`` on ``meta`` keep the reference's stacked
    trees: each leaf's spec has as many entries as the leaf has dims."""
    adapter = TS.get_adapter(port_config(arch, variant))
    params = params_struct(adapter)
    cache = adapter.init_cache(2, 64, "meta")
    pairs = [(params, adapter.pspecs(2, "data")),  # 2: qwen3 SMOKE's 8 experts in EP
             (cache, adapter.cache_pspecs(("data",), None, 2))]
    for tree, specs in pairs:
        leaves = tree_leaves_with_path(tree)
        spec_leaves = tree_leaves_with_path(specs, is_leaf=is_spec)
        assert [k for k, _ in leaves] == [k for k, _ in spec_leaves]
        for (path, x), (_, s) in zip(leaves, spec_leaves):
            assert x.device.type == "meta", path
            assert len(s) == x.ndim, (path, s, tuple(x.shape))
