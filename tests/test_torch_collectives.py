"""The rank-mesh collectives and placement (``common/collectives.py``,
``common/sharding.py``) against single-process math, on CPU gloo ranks.

One world of 4 ranks on a (2 data x 2 model) mesh runs every check once
(``_rank_checks``, module-scoped; rendezvous on a ``FileStore`` under the
test's tmp dir, so parallel workers never share a port) and returns its
numbers; the tests read them:

* each autograd collective's forward and backward against the same math
  on whole tensors: :func:`gather` with a summed and a sliced backward,
  :func:`reduce_from`, :func:`copy_to`, :func:`mean_over` (exact: sums of
  a few float32 values in one order);
* ``shard_tree`` then ``gather_tree`` gives back gemma3-1b SMOKE's
  parameters and AdamW state bitwise;
* the sharded ``global_norm`` (replicated leaves counted once) within
  1e-6 relative of the single-process one;
* every call's counted bytes are its output's, and a staged mesh counts
  the bytes it copied.

Without ranks: each rank's slice of every gemma3-1b SMOKE leaf has
``shard_shape``'s shape at (4, 2) and (3, 2), and the slices tile the leaf.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.common import collectives as C
from repro_torch.common.sharding import (
    P,
    RankMesh,
    gather_tree,
    is_spec,
    mesh_coords,
    shard_shape,
    shard_tree,
)
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path, tree_unflatten
from repro_torch.common.types import Mesh
from repro_torch.configs import get_lm_config
from repro_torch.launch import distributed as D
from repro_torch.launch.steps import get_adapter, opt_pspecs
from repro_torch.optim import init_adamw
from repro_torch.optim.adamw import global_norm

MESH = (2, 2)
#: the sharded global norm against the single-process one, relative
NORM_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gemma_state():
    cfg = get_lm_config("gemma3-1b", "smoke")
    adapter = get_adapter(cfg)
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    opt = init_adamw(params)
    gen = torch.Generator().manual_seed(1)
    opt = opt._replace(m=tree_unflatten(opt.m, [torch.randn(x.shape, generator=gen)
                                                 for x in tree_leaves(opt.m)]))
    return adapter, params, opt


def _full(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _rank_checks(device: torch.device) -> dict:
    """Every check's numbers on this rank of the (2, 2) world."""
    mesh = RankMesh.build(MESH, device=device)
    d, m = mesh.coords["data"], mesh.coords["model"]
    out = {"coords": mesh.coords}

    # gather over "data" along dim 1, gradient summed: each data rank weighs
    # the whole tensor by its own w_d, so d/dx_shard = slice of sum_d w_d
    x = _full((3, 8), 0)
    w = [_full((3, 8), 10 + i) for i in range(2)]
    shard = x[:, 4 * d:4 * d + 4].clone().requires_grad_()
    y = C.gather(shard, mesh, "data", 1, summed=True)
    (y * w[d]).sum().backward()
    out["gather_fwd"] = float((y.detach() - x).abs().max())
    out["gather_bwd"] = float((shard.grad - (w[0] + w[1])[:, 4 * d:4 * d + 4]).abs().max())
    out["gather_count"] = mesh.counts[("all-gather", "data", "forward")] == y.numel() * 4
    out["rs_count"] = mesh.counts[("reduce-scatter", "data.grad", "forward")] == shard.numel() * 4

    # gather over "model" computed the same on each model rank: its own slice
    shard = x[m:m + 1].clone().requires_grad_()  # rows [m, m + 1) of x[:2]
    y = C.gather(shard, mesh, "model", 0, summed=False)
    (y * w[0][:2]).sum().backward()
    out["replicated_bwd"] = float((shard.grad - w[0][m:m + 1]).abs().max())

    # row-parallel: forward sums the model ranks' partials, backward passes g
    part = (_full((2, 5), 20 + m)).requires_grad_()
    y = C.reduce_from(part, mesh, "model", tag="t")
    (y * w[0][:2, :5]).sum().backward()
    out["reduce_fwd"] = float((y.detach() - (_full((2, 5), 20) + _full((2, 5), 21))).abs().max())
    out["reduce_bwd"] = float((part.grad - w[0][:2, :5]).abs().max())

    # column-parallel: forward the identity, backward sums the partial grads
    xin = _full((2, 5), 30).requires_grad_()
    y = C.copy_to(xin, mesh, "model", tag="t")
    (y * _full((2, 5), 40 + m)).sum().backward()
    out["copy_fwd"] = float((y - xin).detach().abs().max())
    out["copy_bwd"] = float((xin.grad - (_full((2, 5), 40) + _full((2, 5), 41))).abs().max())

    # pmean over "data": the mean forward; data rank d weighs it by 1 + d, so
    # each a_d's gradient is the mean of the weights, (1 + 2) / 2
    a = (_full((), 50 + d)).requires_grad_()
    y = C.mean_over(a, mesh, "data", tag="t")
    (y * (1.0 + d)).backward()
    out["mean_fwd"] = float((y.detach() - (_full((), 50) + _full((), 51)) / 2).abs())
    out["mean_bwd"] = float((a.grad - 1.5).abs())

    # shard_tree -> gather_tree, bitwise; the norm of the shards
    adapter, params, opt = _gemma_state()
    specs = adapter.pspecs(MESH[1])
    tree, tspecs = {"params": params, "opt": opt}, {"params": specs, "opt": opt_pspecs(specs)}
    shards = shard_tree(tree, tspecs, mesh.mesh, mesh.coords)
    back = gather_tree(shards, tspecs, mesh)
    out["round_trip_bitwise"] = all(torch.equal(a, b) and a.dtype == b.dtype
                                    for a, b in zip(tree_leaves(tree), tree_leaves(back)))
    out["norm"] = float(global_norm(shards["opt"].m, mesh, specs))

    # staged: the operand and the result each counted once
    mesh.reset_counts()
    mesh.staged = True
    y = C.all_reduce(_full((4, 4), 60), mesh, None, tag="s")
    out["staged"] = dict(mesh.staged_bytes)
    out["staged_count"] = dict(mesh.counts)
    out["staged_seconds"] = sorted(mesh.seconds)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("collectives") / "rendezvous")
    return D.run_ranks(_rank_checks, (), D.choose_backend("cpu", 4), store, timeout_s=120)


def test_ranks_sit_row_major(ranks):
    assert [r["coords"] for r in ranks] == [mesh_coords(Mesh(MESH, ("data", "model")), i)
                                             for i in range(4)]
    assert [tuple(r["coords"].values()) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("check", ["gather_fwd", "gather_bwd", "replicated_bwd", "reduce_fwd",
                                   "reduce_bwd", "copy_fwd", "copy_bwd", "mean_fwd", "mean_bwd"])
def test_autograd_collective_matches_whole_tensor_math(ranks, check):
    assert max(r[check] for r in ranks) <= 1e-6, [r[check] for r in ranks]


def test_counts_are_output_bytes(ranks):
    assert all(r["gather_count"] and r["rs_count"] for r in ranks)


def test_staged_collective_counts_its_host_copies(ranks):
    for r in ranks:
        assert r["staged"] == {"all-reduce": 2 * 16 * 4}
        assert r["staged_count"] == {("all-reduce", "s", "forward"): 16 * 4}
        assert r["staged_seconds"] == ["all-reduce", "copy", "device"]


def test_shard_then_gather_is_bitwise(ranks):
    assert all(r["round_trip_bitwise"] for r in ranks)


def test_sharded_global_norm_counts_replicated_leaves_once(ranks):
    _, _, opt = _gemma_state()
    want = float(global_norm(opt.m))
    got = [r["norm"] for r in ranks]
    assert max(abs(g - want) for g in got) <= NORM_RTOL * want, (got, want)
    assert len(set(got)) == 1


@pytest.mark.parametrize("shape", [(4, 2), (3, 2)])
def test_each_rank_holds_shard_shape_and_the_slices_tile(shape):
    adapter, params, opt = _gemma_state()
    specs = adapter.pspecs(shape[1])
    tspecs = {"params": specs, "opt": opt_pspecs(specs)}
    tree = {"params": params, "opt": opt}
    mesh = Mesh(shape, ("data", "model"))
    per_rank = [shard_tree(tree, tspecs, mesh, mesh_coords(mesh, r)) for r in range(mesh.size)]
    leaves = tree_leaves_with_path(tspecs, is_leaf=is_spec)
    for i, ((path, spec), full) in enumerate(zip(leaves, tree_leaves(tree))):
        want = shard_shape(mesh, spec, full.shape)
        covered = torch.zeros(full.shape, dtype=torch.bool)
        for r in range(mesh.size):
            got = tree_leaves(per_rank[r])[i]
            assert tuple(got.shape) == want, path
            # the rank's block: row-major over the entry's axes, as JAX numbers it
            coords, idx = mesh_coords(mesh, r), []
            for entry, n in zip(spec, want):
                k = 0
                for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                    k = k * mesh.shape[a] + coords[a]
                idx.append(slice(k * n, (k + 1) * n))
            assert torch.equal(got, full[tuple(idx)]), path
            covered[tuple(idx)] = True
        assert bool(covered.all()), path


def test_gather_leaf_refuses_a_dimension_over_two_axes():
    mesh = RankMesh(Mesh((1, 1), ("data", "model")), 0, {"data": 0, "model": 0},
                    {"data": None, "model": None}, torch.device("cpu"))
    with pytest.raises(ValueError, match="not gathered here"):
        C.gather_leaf(torch.zeros(4), P(("data", "model")), mesh)


def test_rank_function_runs_in_a_spawned_world_and_a_failure_fails_the_run(tmp_path):
    store = str(tmp_path / "rendezvous")
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        D.run_ranks(_fails_on_rank_one, (), D.choose_backend("cpu", 2), store, timeout_s=60)
    assert not os.path.exists(store)


def _fails_on_rank_one(device: torch.device):
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()  # rank 0 waits on the rank that failed; the run stops it
    return np.zeros(1)
