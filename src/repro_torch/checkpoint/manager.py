"""Sharded, atomic, keep-K checkpointing with auto-resume.

Port of ``repro/checkpoint/manager.py`` with the same layout on disk (one
directory per step):

    <root>/step_000120/
        meta.json                   # step, leaf count, host count
        host00.npz ... hostNN.npz   # per-host shards (flat key -> array)
        COMMIT                      # written last; a checkpoint without it
                                    # is torn and ignored by restore

Writes go to ``step_XXXX.tmp`` and are renamed into place only after the
COMMIT marker lands, so a preempted host can never publish a half-written
checkpoint.  ``restore_latest`` walks backwards over steps until it finds
a committed one: if the newest write was torn by a failure, training
resumes from the previous good step.

The flat keys are the strings ``jax.tree_util.keystr`` writes for the same
tree (``['params']['down'][0]['res']['conv1']['w']``, ``['opt'].m[...]``),
so a checkpoint written by either package restores in the other.  Leaves
may be tensors (on any device) or numpy arrays; ``restore`` gives each leaf
its template's type, dtype and device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Any

import numpy as np
import torch

from repro_torch.common.tree import tree_leaves_with_path, tree_unflatten


def _to_savable(leaf: Any) -> np.ndarray:
    """npz cannot hold bfloat16 (nor numpy's ml_dtypes); widen them to
    float32.  The template restores the dtype at load time, so the
    bf16 -> fp32 -> bf16 round trip is bit-exact."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype not in (np.float16, np.float32, np.float64) and arr.dtype.kind == "V":
        return arr.astype(np.float32)
    if arr.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        return arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_savable(leaf) for key, leaf in tree_leaves_with_path(tree)}


def _like(leaf: Any, arr: np.ndarray) -> Any:
    """``arr`` with the shape, dtype, type and device of the template ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr).reshape(leaf.shape))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr).reshape(np.shape(leaf)).astype(np.result_type(leaf))


def _unflatten(tree_like: Any, flat: dict[str, np.ndarray]) -> Any:
    leaves = [_like(leaf, flat[key]) for key, leaf in tree_leaves_with_path(tree_like)]
    return tree_unflatten(tree_like, leaves)


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.root, name + ".tmp")
        final = os.path.join(self.root, name)
        os.makedirs(tmp, exist_ok=True)

        flat = _flatten(tree)
        np.savez(os.path.join(tmp, f"host{self.process_index:02d}.npz"), **flat)
        if self.process_index == 0:
            meta = {
                "step": step,
                "time": time.time(),
                "process_count": self.process_count,
                "n_leaves": len(flat),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # commit marker last; rename is atomic on POSIX
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        return final

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.root, d, "COMMIT")):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, tree_like: Any) -> Any:
        path = os.path.join(self.root, f"step_{step:08d}", f"host{self.process_index:02d}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(tree_like, flat)

    def restore_latest(self, tree_like: Any) -> tuple[int, Any] | None:
        for step in reversed(self.list_steps()):
            try:
                return step, self.restore(step, tree_like)
            except Exception:
                continue  # torn shard: fall back to the previous commit
        return None
