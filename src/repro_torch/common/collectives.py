"""The collectives GSPMD inserts into the reference's mesh step, written down.

The JAX package jits one train step over a ``("data", "model")`` mesh and
GSPMD adds the communication.  The port runs a rank a mesh position
(``common/sharding.py::RankMesh``) and calls these:

* :func:`gather` -- all-gather over one axis; its backward is a
  reduce-scatter of the gradient where the ranks of that axis computed
  different things (always over "data", whose ranks hold other batch
  rows), and a slice of the rank's own part where they computed the same
  thing (a leaf gathered over "model" for a replicated product);
* :func:`reduce_from` -- the row-parallel all-reduce of partial sums over
  "model"; its backward is the identity;
* :func:`copy_to` -- the column-parallel identity; its backward all-reduces
  the partial input gradients over "model";
* :func:`mean_over` -- ``jax.lax.pmean``: forward and backward average over
  the axis;
* :func:`gather_leaf` -- a leaf's shard gathered over the axes its spec
  names, "data" first;
* plain :func:`all_gather`, :func:`reduce_scatter` and :func:`all_reduce`
  for the rest (checkpoints, gradients of replicated leaves, scalars).

Every call adds its output bytes on this rank -- the gathered tensor, the
scattered shard, the reduced tensor -- to ``RankMesh.counts`` under
``(kind, tag, phase)``: the dry run's kinds
(``launch/dryrun.py::collectives_from_specs``), the axis or the purpose as
the tag (``.grad`` appended for a call made in an autograd backward), and
the step's phase.  A forward call counted in phase ``backward`` is a
checkpointed unit's recompute.

On ranks that share one card under gloo (``RankMesh.staged``), each call
copies its operand to the host, runs there and copies the result back; the
bytes are counted in ``RankMesh.staged_bytes`` and the wall seconds in
``RankMesh.seconds``.  NCCL ranks and CPU ranks run the collective on the
tensors where they are.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.common.sharding import P, RankMesh, batch_axes, entry_axes, is_spec
from repro_torch.common.tree import tree_map

# torch 2.13 renames the single-tensor forms; older versions have only the old names
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _collective(mesh: RankMesh, kind: str, tag: str, x: torch.Tensor, op) -> torch.Tensor:
    """``op(x)`` (a new tensor), on a host copy of ``x`` when the mesh is
    staged; counts the output's bytes.  Staged, the rank's wall seconds go
    to ``RankMesh.seconds``: waiting for the card's queued work
    (``device``), the two copies (``copy``), the collective (its kind)."""
    x = x.contiguous()
    if not mesh.staged:
        out = op(x)
    else:
        t0 = time.perf_counter()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t1 = time.perf_counter()
        src = x.to("cpu")
        t2 = time.perf_counter()
        out = op(src)
        t3 = time.perf_counter()
        out = out.to(mesh.device)
        t4 = time.perf_counter()
        mesh.staged_bytes[kind] += _nbytes(src) + _nbytes(out)
        mesh.seconds["device"] += t1 - t0
        mesh.seconds["copy"] += (t2 - t1) + (t4 - t3)
        mesh.seconds[kind] += t3 - t2
    mesh.counts[(kind, tag, mesh.phase)] += _nbytes(out)
    return out


def all_gather(x: torch.Tensor, mesh: RankMesh, axis: str, dim: int = 0, *,
               tag: str | None = None) -> torch.Tensor:
    """The axis's shards of ``x`` concatenated along ``dim``, in the order of
    the ranks' indices on the axis."""
    n = mesh.size(axis)
    if n == 1:
        return x

    def op(src):
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        _all_gather_single(out, src, group=mesh.groups[axis])
        return out

    return _collective(mesh, "all-gather", tag or axis, x.movedim(dim, 0),
                       op).movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, mesh: RankMesh, axis: str, dim: int = 0, *,
                   tag: str | None = None) -> torch.Tensor:
    """The sum of ``x`` over the axis's ranks, split along ``dim``: this
    rank's part (the inverse layout of :func:`all_gather`)."""
    n = mesh.size(axis)
    if n == 1:
        return x

    def op(src):
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _reduce_scatter_single(out, src, group=mesh.groups[axis])
        return out

    return _collective(mesh, "reduce-scatter", tag or axis, x.movedim(dim, 0),
                       op).movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, mesh: RankMesh, axis: str | None, *, tag: str) -> torch.Tensor:
    """The sum of ``x`` over the axis's ranks (``axis=None``: every rank), in
    a new tensor."""
    if (mesh.mesh.size if axis is None else mesh.size(axis)) == 1:
        return x

    def op(src):
        out = src.clone()
        dist.all_reduce(out, group=None if axis is None else mesh.groups[axis])
        return out

    return _collective(mesh, "all-reduce", tag, x, op)


# ---------------------------------------------------------------------------
# Autograd collectives
# ---------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, summed):
        ctx.args = (mesh, axis, dim, summed)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, summed = ctx.args
        if summed:
            return reduce_scatter(g, mesh, axis, dim, tag=f"{axis}.grad"), None, None, None, None
        n = g.shape[dim] // mesh.size(axis)
        return g.narrow(dim, mesh.coords[axis] * n, n), None, None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        return all_reduce(x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return all_reduce(g, mesh, axis, tag=f"{tag}.grad"), None, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return all_reduce(x, mesh, axis, tag=tag) / mesh.size(axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return all_reduce(g, mesh, axis, tag=f"{tag}.grad") / mesh.size(axis), None, None, None


def gather(x: torch.Tensor, mesh: RankMesh, axis: str, dim: int, *, summed: bool) -> torch.Tensor:
    """:func:`all_gather` under autograd.  ``summed``: the axis's ranks use
    the gathered tensor on different data, so the gradient is the sum of
    theirs (a reduce-scatter); otherwise they computed the same thing and
    each keeps its own part of its gradient."""
    if mesh.size(axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim, summed)


def reduce_from(x: torch.Tensor, mesh: RankMesh, axis: str, *, tag: str) -> torch.Tensor:
    """Row-parallel: sum the axis's partial results (backward: identity)."""
    return x if mesh.size(axis) == 1 else _ReduceFrom.apply(x, mesh, axis, tag)


def copy_to(x: torch.Tensor, mesh: RankMesh, axis: str, *, tag: str) -> torch.Tensor:
    """Column-parallel: the identity, whose backward sums the axis's
    partial input gradients."""
    return x if mesh.size(axis) == 1 else _CopyTo.apply(x, mesh, axis, tag)


def mean_over(x: torch.Tensor, mesh: RankMesh, axis: str, *, tag: str) -> torch.Tensor:
    """``jax.lax.pmean``: the mean over the axis's ranks, whose backward
    averages the cotangents over them."""
    return x if mesh.size(axis) == 1 else _MeanOver.apply(x, mesh, axis, tag)


def gather_leaf(x: torch.Tensor, spec: P, mesh: RankMesh, *, keep: tuple[str, ...] = (),
                summed: tuple[str, ...] = ()) -> torch.Tensor:
    """A rank's shard ``x`` of a leaf laid out by ``spec``, gathered over
    every axis the spec names except ``keep``: the batch axes first (to the
    shape the dry run counts), then the others.  The gradient sums over the
    batch axes and over ``summed``; over any other axis the ranks computed
    the same thing.  A spec entry may name one axis."""
    batch = batch_axes(mesh.mesh)
    named = []
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if len(axes) > 1:
            raise ValueError(f"spec {spec}: a dimension split over {axes} is not gathered here")
        named += [(a not in batch, dim, a) for a in axes if a not in keep]
    for _, dim, axis in sorted(named):
        x = gather(x, mesh, axis, dim, summed=axis in batch or axis in summed)
    return x


def gather_params(tree, specs, mesh: RankMesh, *, keep: tuple[str, ...] = ()):
    """:func:`gather_leaf` over a tree of shards and its spec tree."""
    return tree_map(lambda s, x: gather_leaf(x, s, mesh, keep=keep), specs, tree, is_leaf=is_spec)
