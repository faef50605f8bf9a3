"""The port's partition-spec helpers (``repro_torch.common.sharding``) and
mesh descriptions (``repro_torch.launch.mesh``) against the reference's.

The reference's meshes are ``AbstractMesh`` here (``jax.make_mesh`` would
want 256 devices), and its ``NamedSharding.shard_shape`` is the oracle of
each device's share.  No device is touched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro.common import sharding as RSH
from repro.launch import mesh as RM
from repro_torch.common import sharding as SH
from repro_torch.common.sharding import P
from repro_torch.launch import mesh as TM

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((4, 2), ("data", "model"))]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_mesh_descriptions_match_the_reference(monkeypatch):
    """make_production_mesh (both) and make_host_mesh: the reference's
    shapes and axis names, read through an abstract ``jax.make_mesh``."""
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: AbstractMesh(shape, axes))
    pairs = [(RM.make_production_mesh(), TM.make_production_mesh()),
             (RM.make_production_mesh(multi_pod=True), TM.make_production_mesh(multi_pod=True)),
             (RM.make_host_mesh(), TM.make_host_mesh())]
    for ref, port in pairs:
        assert tuple(port.axis_names) == tuple(ref.axis_names)
        assert port.shape == dict(ref.shape)
        assert port.size == ref.size
    assert [m.size for _, m in pairs] == [256, 512, 1]


def test_h100_constants_replace_every_tpu_one():
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.LINK_BW, TM.NVLINK_BW) == (989e12, 3.35e12,
                                                                        50e9, 450e9)
    assert 80e9 < TM.HBM_BYTES < 81 * 2**30
    assert not hasattr(TM, "ICI_BW_PER_LINK")
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"):
        assert getattr(TM, name) != getattr(RM, name), name


@pytest.mark.parametrize("shape,names", MESHES)
def test_mesh_helpers_match_the_reference(shape, names):
    ref, port = AbstractMesh(shape, names), SH.Mesh(shape, names)
    assert SH.batch_axes(port) == RSH.batch_axes(ref)
    assert SH.dp_size(port) == RSH.dp_size(ref)
    assert SH.tp_size(port) == RSH.tp_size(ref)


def test_spec_helpers_match_the_reference():
    for entries in [(), (None,), ("data", "model"), (("pod", "data"), None, "model"),
                    (("data",), None), ((), "model")]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
        assert tuple(SH.stacked(P(*entries))) == tuple(RSH.stacked(JP(*entries)))
        assert isinstance(SH.stacked(P(*entries)), P)
    for dim, size, axis in [(32001, 16, "model"), (32000, 16, "model"), (7, 1, "data"),
                            (8, 16, None)]:
        assert SH.divisible_spec(dim, size, axis) == RSH.divisible_spec(dim, size, axis)


def _random_case(rng, names):
    ndim = int(rng.integers(1, 5))
    free = list(names)
    rng.shuffle(free)
    spec = []
    for _ in range(int(rng.integers(0, ndim + 1))):
        r = rng.random()
        if r < 0.35 or not free:
            spec.append(None)
        elif r < 0.75 or len(free) < 2:
            spec.append(free.pop())
        else:
            spec.append((free.pop(), free.pop()))
    shape = [int(rng.choice([1, 2, 3, 4, 6, 8, 16, 32, 48, 512])) for _ in range(ndim)]
    return tuple(spec), tuple(shape)


@pytest.mark.parametrize("shape,names", MESHES)
def test_shard_shape_matches_named_sharding(shape, names):
    """Random shapes and specs, tuple axes included: the port's shard shape
    is ``NamedSharding.shard_shape``, and both refuse an uneven tiling."""
    ref_mesh, mesh = AbstractMesh(shape, names), SH.Mesh(shape, names)
    rng = np.random.default_rng(sum(shape))
    n_even = n_uneven = 0
    for _ in range(300):
        spec, arr = _random_case(rng, names)
        try:
            want = NamedSharding(ref_mesh, JP(*spec)).shard_shape(arr)
        except ValueError:
            with pytest.raises(ValueError):
                SH.shard_shape(mesh, P(*spec), arr)
            n_uneven += 1
            continue
        assert SH.shard_shape(mesh, P(*spec), arr) == tuple(want), (spec, arr)
        assert SH.Sharding(mesh, P(*spec)).shard_shape(arr) == tuple(want)
        n_even += 1
    assert n_even > 100
    assert n_uneven > 0 or shape == (1, 1)


def test_shard_shape_refuses_what_a_named_sharding_refuses():
    mesh = SH.Mesh((16, 16), ("data", "model"))
    for spec, shape in [(P("data", "data"), (16, 16)), (P("pod"), (16,)),
                        (P(None, None, None), (4, 4))]:
        with pytest.raises(ValueError):
            SH.shard_shape(mesh, spec, shape)


def test_tree_shard_bytes_and_meta_like():
    mesh = SH.Mesh((2, 4), ("data", "model"))
    tree = {"w": torch.zeros((8, 12), dtype=torch.bfloat16),
            "b": [torch.zeros((6,), dtype=torch.float32)],
            "s": torch.zeros((), dtype=torch.int32)}
    specs = {"w": P("data", "model"), "b": [P(None)], "s": P()}
    assert SH.tree_shard_bytes(mesh, specs, tree) == 4 * 3 * 2 + 6 * 4 + 4
    jtree = {"w": jnp.zeros((8, 12), jnp.bfloat16), "b": [jnp.zeros((6,), jnp.float32)],
             "s": jnp.zeros((), jnp.int32)}
    ref = jax.tree.map(lambda s, x: int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize,
                       RSH.tree_pspecs_to_shardings(
                           AbstractMesh((2, 4), ("data", "model")),
                           {"w": JP("data", "model"), "b": [JP(None)], "s": JP()}), jtree)
    assert SH.tree_shard_bytes(mesh, specs, tree) == sum(jax.tree.leaves(ref))
    meta = SH.meta_like(tree)
    assert all(m.device.type == "meta" for m in (meta["w"], meta["b"][0], meta["s"]))
    assert [(tuple(m.shape), m.dtype) for m in (meta["w"], meta["b"][0], meta["s"])] == [
        ((8, 12), torch.bfloat16), ((6,), torch.float32), ((), torch.int32)]


def test_lane_and_replicated_shardings():
    devs = SH.lane_devices(3, "cpu")
    lane, rep = SH.lane_sharding(devs), SH.replicated_sharding(devs)
    assert lane.spec == P("data") and rep.spec == P()
    assert lane.mesh.shape == {"data": 3} and rep.mesh.size == 3
    assert lane.shard_shape((6, 5)) == (2, 5) and rep.shard_shape((6, 5)) == (6, 5)
    with pytest.raises(ValueError):
        SH.lane_sharding([])
