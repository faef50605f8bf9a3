"""Partition specs over mesh descriptions, and lane-shard placement.

The port's copy of ``repro/common/sharding.py``.

Conventions (the reference's): meshes carry axes ``("data", "model")``
(single pod) or ``("pod", "data", "model")`` (multi-pod).  The batch axis of
activations is sharded over ``batch_axes(mesh)`` = ``("data",)`` or
``("pod", "data")``; tensor-parallel weight dimensions over ``"model"``.
Each model module exposes ``*_pspecs`` functions that mirror its parameter,
cache or state tree with :class:`P` leaves; a layer-stacked leaf (leading
layer axis) gets a ``None`` prepended (:func:`stacked`).

A :class:`Mesh` is a description with no devices, the counterpart of
``jax.sharding.AbstractMesh``; the dry run (``launch/dryrun.py``) reads the
specs over one to cost each device's share of a step.  :func:`shard_shape`
is ``NamedSharding.shard_shape``.

The port runs no SPMD program.  Where the JAX package jits one step over a
mesh of devices and lets GSPMD partition it, the port runs one
``torch.distributed`` rank a mesh position: a :class:`RankMesh` is this
rank's place on the mesh (row-major coordinates, as
``np.array(devices).reshape(sizes)`` orders devices) with one process
group per axis line through it.  :func:`shard_tree` is ``device_put``
(slice a full tree into one rank's shards), :func:`gather_tree` is
``device_get`` (rebuild the full tree on every rank), and
:func:`set_rank_mesh` / :func:`get_rank_mesh` / :func:`using_rank_mesh`
are the counterparts of ``set_activation_mesh`` / ``get_activation_mesh``:
the LM layers and the train step read the rank mesh where the reference
reads the activation mesh, and then take the rank's shards and its batch
rows.  The collectives GSPMD would insert are written down in
``common/collectives.py``.

The serving engine's lane shards run on real devices: the JAX package
shards its lane axis over a 1-D ``("data",)`` mesh of the first N devices
and runs one GSPMD program; the port holds one lane shard per device of a
plain device list (:func:`lane_devices`) and issues each shard's work on
its own device.

No counterpart: ``set_scan_unroll``, ``scan_unroll``,
``set_attn_kv_gather``, ``constrain_qkv`` and ``constrain_act``.  They are
hints to GSPMD's partitioner; the port's layer stacks are Python loops, so
there is nothing to unroll, and it places activations itself.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.tree import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.common.types import Mesh


class P(tuple):
    """A partition spec: one entry per leading dimension of an array, each
    ``None`` (replicated), a mesh axis name, or a tuple of axis names (the
    dimension is split over their product).  Dimensions past the last entry
    are replicated.  Immutable, and compared as the tuple of its entries.
    As in JAX, a tuple of one axis is stored as that axis, and an empty
    tuple as ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def is_spec(x: Any) -> bool:
    """Whether ``x`` is a spec leaf of a spec tree (the ``is_leaf`` of the
    tree helpers: a :class:`P` is a tuple, not a container)."""
    return isinstance(x, P)


class Sharding(NamedTuple):
    """A spec over a mesh: the counterpart of ``NamedSharding``."""

    mesh: Mesh
    spec: P

    def shard_shape(self, shape) -> tuple[int, ...]:
        return shard_shape(self.mesh, self.spec, shape)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes over which the global batch is sharded."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh: Mesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh.shape[a]
    return out


def tp_size(mesh: Mesh) -> int:
    return mesh.shape["model"]


def stacked(spec: P) -> P:
    """Prepend a replicated leading axis (for layer-stacked params)."""
    return P(None, *spec)


def divisible_spec(dim: int, axis_size: int, spec_axis: str | None) -> str | None:
    """Drop a sharding axis when the dimension does not divide evenly.

    Explicit shardings need even tiling; rather than padding weights the
    offending dimension replicates (it should only fire for odd vocab sizes
    like 32001).
    """
    if spec_axis is None:
        return None
    return spec_axis if dim % axis_size == 0 else None


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(mesh: Mesh, spec: P, shape) -> tuple[int, ...]:
    """Each device's share of an array of ``shape`` laid out by ``spec``.

    Raises ``ValueError`` when the spec is longer than the shape, names an
    axis the mesh lacks or names one axis twice, or when a dimension does
    not divide evenly over its axes, as explicit GSPMD in-shardings do."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape} has dimensions")
    seen: list[str] = []
    out = list(shape)
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in mesh {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            seen.append(a)
        n = math.prod(mesh.shape[a] for a in axes)
        if shape[i] % n:
            raise ValueError(
                f"dimension {i} of shape {shape} ({shape[i]}) does not divide evenly over "
                f"{axes} ({n} devices) under spec {spec}")
        out[i] = shape[i] // n
    return tuple(out)


def shard_bytes(mesh: Mesh, spec: P, x: torch.Tensor) -> int:
    """Bytes of each device's share of ``x``."""
    return math.prod(shard_shape(mesh, spec, x.shape)) * x.element_size()


def tree_shard_bytes(mesh: Mesh, specs: Any, tree: Any) -> int:
    """Each device's bytes of ``tree`` laid out by the spec tree ``specs``
    (a spec per leaf, same structure): the counterpart of
    ``tree_pspecs_to_shardings`` and a sum of the shards' bytes."""
    sizes = tree_map(lambda s, x: shard_bytes(mesh, s, x), specs, tree, is_leaf=is_spec)
    return sum(tree_leaves(sizes))


def meta_like(tree: Any) -> Any:
    """A tree of ``meta`` tensors with ``tree``'s shapes and dtypes: the
    counterpart of ``abstract_like``'s ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)


def spec_leaves(specs: Any) -> list[P]:
    """The spec leaves of a spec tree in JAX's flatten order (a :class:`P`
    is a tuple, which the plain tree helpers would walk into)."""
    return [s for _, s in tree_leaves_with_path(specs, is_leaf=is_spec)]


# ---------------------------------------------------------------------------
# Ranks on a mesh: the placement GSPMD does, done by hand
# ---------------------------------------------------------------------------


def mesh_coords(mesh: Mesh, rank: int) -> dict[str, int]:
    """Rank ``rank``'s index on each axis: row-major over the axis sizes, as
    ``np.array(devices).reshape(sizes)`` places device ``rank``."""
    out = {}
    for name, size in reversed(tuple(zip(mesh.axis_names, mesh.axis_sizes))):
        rank, out[name] = divmod(rank, size)
    return {name: out[name] for name in mesh.axis_names}


@dataclasses.dataclass(eq=False)
class RankMesh:
    """This process's place on a mesh of ``torch.distributed`` ranks.

    ``coords`` are the rank's :func:`mesh_coords`; ``groups[axis]`` is the
    process group of the ranks that differ from this one along ``axis``
    alone (``None`` for an axis of size 1); ``device`` holds the rank's
    tensors.  ``staged`` says the collectives run on host copies (gloo ranks
    that share a card, ``common/collectives.py``).  ``counts`` holds the
    output bytes of each collective the rank ran, keyed ``(kind, tag,
    phase)`` in the dry run's kinds; ``staged_bytes`` the bytes each kind
    copied between the card and the host; ``phase`` is set by the train
    step (``forward``, ``backward``, ``update``)."""

    mesh: Mesh
    rank: int
    coords: dict[str, int]
    groups: dict[str, Any]
    device: torch.device
    staged: bool = False
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    staged_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    seconds: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    phase: str = "forward"

    @classmethod
    def build(cls, axis_sizes, axis_names=("data", "model"), device="cpu") -> "RankMesh":
        """The mesh over the initialised default process group, whose world
        size must be the mesh's.  Collective: every rank calls it, since each
        rank takes part in creating every axis line's group."""
        import torch.distributed as dist

        mesh = Mesh(tuple(axis_sizes), tuple(axis_names))
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != mesh.size:
            raise ValueError(f"a {mesh.shape} mesh needs {mesh.size} ranks, the world has {world}")
        groups: dict[str, Any] = {}
        for axis in mesh.axis_names:
            lines: dict[tuple, list[int]] = {}
            for r in range(world):
                at = mesh_coords(mesh, r)
                lines.setdefault(tuple(v for a, v in at.items() if a != axis), []).append(r)
            for ranks in lines.values():  # in one order on every rank
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[axis] = group
        device = torch.device(device)
        return cls(mesh, rank, mesh_coords(mesh, rank), groups, device,
                   staged=dist.get_backend() == "gloo" and device.type == "cuda")

    def size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def owns(self, spec: P) -> bool:
        """Whether this rank is the one that counts a leaf laid out by
        ``spec`` once: index 0 on every axis the spec does not split."""
        named = {a for e in spec for a in entry_axes(e)}
        return all(i == 0 for a, i in self.coords.items() if a not in named)

    def reset_counts(self) -> None:
        self.counts.clear()
        self.staged_bytes.clear()
        self.seconds.clear()


def _slices(mesh: Mesh, spec: P, shape, coords: dict[str, int]) -> tuple[slice, ...]:
    local = shard_shape(mesh, spec, shape)
    out = []
    for i, entry in enumerate(spec):
        k = 0
        for a in entry_axes(entry):  # the first axis is the major one, as in JAX
            k = k * mesh.shape[a] + coords[a]
        out.append(slice(k * local[i], (k + 1) * local[i]))
    return tuple(out)


def shard_tree(tree: Any, specs: Any, mesh: Mesh, coords: dict[str, int]) -> Any:
    """The shards of the full ``tree`` that the rank at ``coords`` holds under
    ``specs`` (``device_put`` onto a mesh): each leaf sliced to
    :func:`shard_shape`, a copy of its own, so the full tree can be freed."""
    return tree_map(lambda s, x: x[_slices(mesh, s, x.shape, coords)].clone(), specs, tree,
                    is_leaf=is_spec)


def gather_tree(tree: Any, specs: Any, rank_mesh: "RankMesh") -> Any:
    """The full tree on every rank from each rank's shards under ``specs``
    (``device_get``): collective, every rank calls it.  Counted in phase
    ``gather``."""
    from repro_torch.common import collectives as C

    phase, rank_mesh.phase = rank_mesh.phase, "gather"
    try:
        with torch.no_grad():
            return tree_map(lambda s, x: C.gather_leaf(x, s, rank_mesh), specs, tree,
                            is_leaf=is_spec)
    finally:
        rank_mesh.phase = phase


_RANK_MESH: list[RankMesh | None] = [None]


def set_rank_mesh(mesh: RankMesh | None) -> None:
    """Register this process's rank mesh (``set_activation_mesh``'s
    counterpart): while one is set, the LM forward takes the rank's shards
    and batch rows."""
    _RANK_MESH[0] = mesh


def get_rank_mesh() -> RankMesh | None:
    return _RANK_MESH[0]


@contextlib.contextmanager
def using_rank_mesh(mesh: RankMesh | None):
    """:func:`set_rank_mesh` for the body of a ``with``, the previous mesh
    restored after."""
    prev = _RANK_MESH[0]
    _RANK_MESH[0] = mesh
    try:
        yield mesh
    finally:
        _RANK_MESH[0] = prev


# ---------------------------------------------------------------------------
# Lane shards on real devices
# ---------------------------------------------------------------------------


def lane_devices(n_shards: int, device="cuda") -> list[torch.device]:
    """The device of each of ``n_shards`` lane shards.

    On a CUDA device shard ``d`` lives on card ``k + d``, ``k`` being the
    device's index (0 for plain ``"cuda"``); on the CPU every shard is
    ``cpu``, the counterpart of the JAX package's forced host devices.
    Raises when the cards are too few, as ``repro``'s ``lane_mesh`` does.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n_shards
    first = dev.index or 0
    avail = torch.cuda.device_count()
    if first + n_shards > avail:
        raise ValueError(
            f"lane shards want cards {first}..{first + n_shards - 1} but only {avail} are "
            "visible; lower n_shards or place every shard on device='cpu'"
        )
    return [torch.device("cuda", first + d) for d in range(n_shards)]


def _lane_mesh(devices: list[torch.device]) -> Mesh:
    if not devices:
        raise ValueError("a lane mesh needs at least one device")
    return Mesh((len(devices),), ("data",))


def lane_sharding(devices: list[torch.device]) -> Sharding:
    """Leading-axis (lane / slot) sharding over the lane devices."""
    return Sharding(_lane_mesh(devices), P("data"))


def replicated_sharding(devices: list[torch.device]) -> Sharding:
    return Sharding(_lane_mesh(devices), P())


def resolve_device(device) -> torch.device:
    """``device`` with its card index filled in (plain ``"cuda"`` is the
    current card), so it compares equal to the ``.device`` of its tensors."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op context:
    work issued inside goes to ``device``'s context and current stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
