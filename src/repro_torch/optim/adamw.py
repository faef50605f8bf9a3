"""AdamW with an optional compressed gradient all-reduce (error-feedback
int8) for bandwidth-limited data parallelism.

Port of ``repro/optim/adamw.py``: plain functions on trees of tensors, run
under ``torch.no_grad()``, not ``torch.optim.AdamW``, whose math differs.
The update clips by the global norm over every leaf first, follows a warmup
plus cosine schedule down to ``min_lr_frac``, and adds ``wd * p`` to the
Adam direction before scaling by the learning rate.  Moments are float32;
the update is computed in float32 and cast back to each leaf's dtype.  The
schedule and the bias corrections are float32 tensors, as the JAX
package's int32 step makes them, never Python doubles.

On a rank mesh (``mesh`` and the parameters' ``specs`` given) the trees are
the rank's shards: the clip's global norm sums each leaf's squares on the
one rank that owns it (``RankMesh.owns``: index 0 on every axis the leaf is
replicated over) and all-reduces the sum over every rank; the rest of the
update is elementwise on the shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.common import collectives as C
from repro_torch.common.sharding import spec_leaves
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # float32 tree
    v: Any  # float32 tree


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def init_adamw(params: Any) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(_zeros32, params),
        v=tree_map(_zeros32, params),
    )


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), as a float32 scalar."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.minimum(
        step.float() / _f32(max(cfg.warmup_steps, 1), step), _f32(1.0, step))
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step),
        0.0, 1.0,
    )
    cos = _f32(0.5, step) * (_f32(1.0, step) + torch.cos(_f32(math.pi, step) * prog))
    frac = _f32(cfg.min_lr_frac, step) + _f32(1 - cfg.min_lr_frac, step) * cos
    return _f32(cfg.lr, step) * warm * frac


def global_norm(tree: Any, mesh=None, specs: Any = None) -> torch.Tensor:
    """The norm of every leaf; on a rank mesh, of the full tree whose shards
    ``tree`` holds under ``specs``."""
    if mesh is None:
        leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
        return torch.sqrt(sum(leaves))
    local = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for x, spec in zip(tree_leaves(tree), spec_leaves(specs)):
        if mesh.owns(spec):
            local = local + torch.sum(torch.square(x.float()))
    return torch.sqrt(C.all_reduce(local, mesh, None, tag="norm"))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState, *, mesh=None,
    specs: Any = None,
) -> tuple[Any, AdamWState]:
    gnorm = global_norm(grads, mesh, specs)
    clip = torch.minimum(_f32(1.0, gnorm), _f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9))
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(_f32(cfg.b1, step), step.float())
    b2c = 1 - torch.pow(_f32(cfg.b2, step), step.float())

    def upd(p, g, m, v):
        gf = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


# ---------------------------------------------------------------------------
# Error-feedback gradient compression (distributed-optimization trick)
# ---------------------------------------------------------------------------


class CompressionState(NamedTuple):
    error: Any  # float32 residual tree


def init_compression(params: Any) -> CompressionState:
    return CompressionState(error=tree_map(_zeros32, params))


def quantize_int8(gf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) of ``gf``: round half to even, as ``jnp.round``."""
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8), scale


@torch.no_grad()
def compress_decompress(g: torch.Tensor, err: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Simulated int8 quantize->allreduce->dequantize with error feedback.

    The quantization happens *before* the DP all-reduce (4x bytes saved on
    the wire for fp32 grads); the residual is added back next step so the
    optimizer sees an unbiased long-run gradient.
    """
    gf = g.float() + err
    q, scale = quantize_int8(gf)
    deq = q.float() * scale
    return deq, gf - deq


def compressed_grads(grads: Any, comp: CompressionState) -> tuple[Any, CompressionState]:
    pairs = [compress_decompress(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(comp.error))]
    new_g = tree_unflatten(grads, [p[0] for p in pairs])
    new_e = tree_unflatten(grads, [p[1] for p in pairs])
    return new_g, CompressionState(error=new_e)
