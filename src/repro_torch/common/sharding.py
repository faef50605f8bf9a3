"""Partition specs over mesh descriptions, and lane-shard placement.

The port's copy of ``repro/common/sharding.py``.

Conventions (the reference's): meshes carry axes ``("data", "model")``
(single pod) or ``("pod", "data", "model")`` (multi-pod).  The batch axis of
activations is sharded over ``batch_axes(mesh)`` = ``("data",)`` or
``("pod", "data")``; tensor-parallel weight dimensions over ``"model"``.
Each model module exposes ``*_pspecs`` functions that mirror its parameter,
cache or state tree with :class:`P` leaves; a layer-stacked leaf (leading
layer axis) gets a ``None`` prepended (:func:`stacked`).

The port runs no SPMD program: a :class:`Mesh` is a description with no
devices, the counterpart of ``jax.sharding.AbstractMesh``, and the specs
are read by the dry run (``launch/dryrun.py``), which costs each device's
share of a step.  :func:`shard_shape` is ``NamedSharding.shard_shape``.

The serving engine's lane shards run on real devices: the JAX package
shards its lane axis over a 1-D ``("data",)`` mesh of the first N devices
and runs one GSPMD program; the port holds one lane shard per device of a
plain device list (:func:`lane_devices`) and issues each shard's work on
its own device.

No counterpart: ``set_activation_mesh``, ``get_activation_mesh``,
``set_scan_unroll``, ``scan_unroll``, ``set_attn_kv_gather``,
``constrain_qkv`` and ``constrain_act``.  They are hints to GSPMD's
partitioner, and the port runs no SPMD program; its layer stacks are
Python loops, so there is nothing to unroll.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.tree import tree_leaves, tree_map
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
