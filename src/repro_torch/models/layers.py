"""Norms, MLPs and MoE layers of the LM transformer family.

The port's copy of ``repro/models/layers.py``.  Parameters live
in plain nested dicts; ``init_*`` builds them from an explicit
``torch.Generator``, ``apply_*`` consumes them.  Dtype policy: weights are
created in ``cfg.dtype`` (bf16 for a full-size LM); norm scales and the
MoE router are float32, and norm statistics and router math run in
float32.

A Python float times a bf16 tensor is a bf16 product with the scalar
rounded to bf16 in JAX, while torch multiplies by the unrounded scalar in
float32 and rounds once; :func:`scalar` rounds such constants to the
tensor's dtype first, so both packages compute the same product.

On a rank mesh (``common/sharding.py::get_rank_mesh``) the MLP and the MoE
experts are tensor-parallel over "model", as the reference's mesh layout
and its MoE ``shard_map`` make them: :func:`gather_mlp` / :func:`gather_moe`
gather a block's shards over "data" to that layout, :func:`apply_mlp` and
:func:`apply_moe` see a rank's f-slice of the weights and sum the partial
products over "model" (``common/collectives.py``).  Given whole weights
(the recurrent families gather every leaf) they compute as off-mesh.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.common import collectives as C
from repro_torch.common.sharding import get_rank_mesh
from repro_torch.common.types import LMConfig, MoESpec

Params = dict[str, Any]

def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32" | "bfloat16") as a torch dtype."""
    return getattr(torch, name)


def scalar(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as JAX rounds a weakly typed
    Python scalar, and returned as a Python float.  ``like * scalar(...)``
    is then JAX's product: the operands' exact float32 product, rounded
    once.  A Python float, not a tensor on ``like``'s device: building a
    CUDA tensor from a host value is a copy that waits for the card."""
    return torch.tensor(value, dtype=like.dtype).item()


def _dense_init(gen: torch.Generator, shape, dtype, device, scale: float | None = None):
    if torch.device(device).type == "meta":  # no values to draw (the dry run's structs)
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Norms — layernorm uses the paper's Eq. (4) one-pass sum/square-sum form.
# ---------------------------------------------------------------------------


def init_norm(cfg: LMConfig, dim: int, device) -> Params:
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: LMConfig, p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        # one-pass statistics (paper Eq. 4): var = E[x^2] - mean^2
        s = torch.mean(xf, dim=-1, keepdim=True)
        sq = torch.mean(xf * xf, dim=-1, keepdim=True)
        var = torch.clamp(sq - s * s, min=0.0)
        y = (xf - s) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``'s formula, each op rounded to ``x``'s dtype as in
    JAX (``torch.sigmoid`` rounds once, and differs from JAX in bf16)."""
    return 1 / (1 + torch.exp(-x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid(x)


def _gelu_sigmoid(x: torch.Tensor) -> torch.Tensor:
    # paper Sec. IV-D: the official sigmoid form of GELU, not F.gelu
    return x * _sigmoid(scalar(1.702, x) * x)


def act_fn(name: str):
    if name == "silu":
        return _silu
    if name == "gelu":
        return _gelu_sigmoid
    raise ValueError(name)


# ---------------------------------------------------------------------------
# Dense MLP (optionally gated)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_in": _dense_init(gen, (d, f), dtype, device),
        "w_out": _dense_init(gen, (f, d), dtype, device),
    }
    if cfg.glu:
        p["w_gate"] = _dense_init(gen, (d, f), dtype, device)
    return p


def gather_mlp(p: Params, specs: Params, mesh) -> Params:
    """The MLP's shards in its compute layout on the rank mesh: gathered over
    "data", the f dimension left split over "model" (``w_in`` / ``w_gate``
    column-parallel, ``w_out`` row-parallel)."""
    return {k: C.gather_leaf(x, specs[k], mesh, keep=("model",)) for k, x in p.items()}


def apply_mlp(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    mesh = get_rank_mesh()
    tp = mesh is not None and p["w_in"].shape[-1] != cfg.d_ff  # this rank's f-slice
    if tp:
        x = C.copy_to(x, mesh, "model", tag="mlp")
    act = act_fn(cfg.act)
    h = x @ p["w_in"]
    if cfg.glu:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    y = h @ p["w_out"]
    return C.reduce_from(y, mesh, "model", tag="mlp") if tp else y


# ---------------------------------------------------------------------------
# MoE with scatter-based capacity dispatch: each (token, k) routing pair
# goes to slot ``expert * C + position_in_expert`` of a padded expert
# buffer, so the work is the expert products alone (no [tokens, E, C]
# one-hot dispatch product).
# ---------------------------------------------------------------------------


def moe_capacity(spec: MoESpec, n_tokens: int) -> int:
    cap = int(math.ceil(n_tokens * spec.top_k * spec.capacity_factor / spec.num_experts))
    return max(8, -(-cap // 8) * 8)  # rounded up to 8, as the reference


def init_moe(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    spec = cfg.moe
    assert spec is not None
    dtype = torch_dtype(cfg.dtype)
    d, f, e = cfg.d_model, spec.d_expert, spec.num_experts
    return {
        "router": _dense_init(gen, (d, e), torch.float32, device),
        "w_in": _dense_init(gen, (e, d, f), dtype, device),
        "w_gate": _dense_init(gen, (e, d, f), dtype, device),
        "w_out": _dense_init(gen, (e, f, d), dtype, device),
    }


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values (a stable descending sort;
    ``torch.topk`` does not promise an order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_one_group(
    cfg: LMConfig, p: Params, xt: torch.Tensor, cap: int, mesh=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatch / compute / combine for one token group. xt: [T, d].  With
    ``mesh``, the experts are this rank's f-slices: the expert buffer's
    input gradient and its output are summed over "model"."""
    spec = cfg.moe
    assert spec is not None
    t, d = xt.shape
    e, k = spec.num_experts, spec.top_k

    logits = xt.float() @ p["router"]  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k(probs, k)  # [T, k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)  # renormalize

    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)  # [E]
    fe = torch.mean(torch.nn.functional.one_hot(top_i, e).float(), dim=(0, 1))
    aux = e * torch.sum(me * fe)

    # position of each routing pair within its expert (token-major priority)
    flat_e = top_i.reshape(-1)  # [T*k]
    onehot = torch.nn.functional.one_hot(flat_e, e)  # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - onehot
    pair_pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]  # [T*k]
    keep = pair_pos < cap
    dest = torch.where(keep, flat_e * cap + pair_pos, e * cap)  # overflow slot

    # scatter tokens into the padded [E*C, d] expert buffer; every dropped
    # pair lands on the overflow row E*C, which is sliced away unread
    src = torch.arange(t, device=xt.device).repeat_interleave(k)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((dest,), xt[src])
    buf = buf[: e * cap].reshape(e, cap, d)
    if mesh is not None:
        buf = C.copy_to(buf, mesh, "model", tag="moe")

    # expert computation (gated MLP per expert)
    act = act_fn(cfg.act)
    h = torch.bmm(buf, p["w_in"])
    g = torch.bmm(buf, p["w_gate"])
    out_buf = torch.bmm(act(g) * h, p["w_out"])  # [E, C, d]
    if mesh is not None:
        out_buf = C.reduce_from(out_buf, mesh, "model", tag="moe")

    # gather back and combine with the gate probabilities
    flat_out = out_buf.reshape(e * cap, d)
    gathered = torch.where(keep[:, None], flat_out[torch.clamp(dest, max=e * cap - 1)],
                           scalar(0.0, flat_out))
    weighted = gathered * top_p.reshape(-1, 1).to(xt.dtype)
    out = torch.zeros((t, d), dtype=xt.dtype, device=xt.device).index_add(0, src, weighted)
    return out, aux


def gather_moe(cfg: LMConfig, p: Params, specs: Params, mesh) -> Params:
    """The MoE layer's shards in its compute layout on the rank mesh, the
    reference's ``shard_map`` in-specs: the router whole, each expert
    weight gathered over "data" with its f dimension split over "model"
    (tensor-parallel storage keeps it so; expert-parallel storage, the
    experts over "model", is gathered whole and each rank keeps its
    f-slice).  Where d_expert does not split over "model" the reference
    takes its off-``shard_map`` branch, and every weight is gathered whole.
    (Its other condition, a global batch that divides over the data
    shards, is the rank-mesh train step's own.)"""
    if cfg.moe.d_expert % mesh.size("model"):
        return C.gather_params(p, specs, mesh)
    out = {"router": C.gather_leaf(p["router"], specs["router"], mesh)}
    m, i = mesh.size("model"), mesh.coords["model"]
    for k in ("w_in", "w_gate", "w_out"):
        f_dim = 1 if k == "w_out" else 2
        if specs[k][f_dim] == "model":
            out[k] = C.gather_leaf(p[k], specs[k], mesh, keep=("model",))
        else:
            whole = C.gather_leaf(p[k], specs[k], mesh, summed=("model",))
            n = whole.shape[f_dim] // m
            out[k] = whole.narrow(f_dim, i * n, n)
    return out


def apply_moe(cfg: LMConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: [B, S, d_model].

    Tokens are dispatched in groups, one per batch row, each with its own
    capacity ``min(moe_capacity, S)``; aux is the mean over the groups.
    On a rank mesh ``x`` is the data shard's rows, each dispatched as
    off-mesh; given f-sliced experts (:func:`gather_moe`) the expert
    products are summed over "model", and aux is the mean over the data
    shards of each shard's mean, as the reference's mesh branch."""
    spec = cfg.moe
    assert spec is not None
    b, s, d = x.shape
    cap = min(moe_capacity(spec, s), s)
    mesh = get_rank_mesh()
    tp = mesh if mesh is not None and p["w_in"].shape[-1] != spec.d_expert else None
    outs, auxs = zip(*(_moe_one_group(cfg, p, x[i], cap, tp) for i in range(b)))
    aux = torch.mean(torch.stack(auxs))
    if mesh is not None:
        aux = C.mean_over(aux, mesh, "data", tag="aux")
    return torch.stack(outs), aux
