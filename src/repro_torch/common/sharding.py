"""Lane-shard placement for the sharded serving engine.

The port's counterpart of the lane-mesh half of ``repro/common/sharding.py``.
The JAX package shards its lane axis over a 1-D ``("data",)`` mesh of the
first N devices and runs one GSPMD program; the port holds one lane shard
per device of a plain device list and issues each shard's work on its own
device.  The rest of that module (parameter specs, mesh costing) has no
counterpart yet.
"""
from __future__ import annotations

import contextlib

import torch


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
