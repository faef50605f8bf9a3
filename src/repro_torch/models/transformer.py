"""Decoder-only LM transformer for the dense, moe, audio and vlm families.

The port's copy of ``repro/models/transformer.py``.  It runs off-mesh;
``lm_pspecs`` / ``cache_pspecs`` give the reference's mesh layout, which
the dry run (``launch/dryrun.py``) costs.  The layer
stack keeps the reference's pattern-unit layout: the config's repeating
layer pattern (gemma3's 5 local + 1 global) forms a unit, the full units'
parameters are stacked on a leading axis (``blocks.slotJ``), and the
partial final repeat (``tail``) is a list.  The reference consumes the
units with one ``lax.scan``; here a loop walks the leading axis, and
``remat=True`` recomputes each unit in the backward
(``torch.utils.checkpoint``).  The parameter tree is the reference's leaf
for leaf, so bridged weights and checkpoints map one to one.

A bf16 model computes in bf16: the embedding table is bf16 and
frontend-stub inputs are cast to ``cfg.dtype``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.sharding import P, is_spec
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.common.types import AttnSpec, LMConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import _dense_init, scalar, torch_dtype

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Per-layer (slot) init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: LMConfig, spec: AttnSpec, device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    p: Params = {
        "norm1": L.init_norm(cfg, d, device),
        "norm2": L.init_norm(cfg, d, device),
        "attn": {
            "wq": _dense_init(gen, (d, cfg.q_dim), dtype, device),
            "wk": _dense_init(gen, (d, cfg.kv_dim), dtype, device),
            "wv": _dense_init(gen, (d, cfg.kv_dim), dtype, device),
            "wo": _dense_init(gen, (cfg.q_dim, d), dtype, device),
        },
    }
    if cfg.qk_norm:
        p["attn"]["q_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32, device=device)
        p["attn"]["k_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32, device=device)
    if cfg.post_norm:
        p["norm1_post"] = L.init_norm(cfg, d, device)
        p["norm2_post"] = L.init_norm(cfg, d, device)
    if cfg.moe is not None:
        p["moe"] = L.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def _rms_head(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Per-layer apply: full-sequence and single-token decode variants
# ---------------------------------------------------------------------------


def _qkv(cfg: LMConfig, p: Params, h: torch.Tensor, positions: torch.Tensor):
    b, s, _ = h.shape
    q = (h @ p["attn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = _rms_head(q, p["attn"]["q_norm"])
        k = _rms_head(k, p["attn"]["k_norm"])
    if cfg.use_rope:
        q = attn_lib.apply_rope(q, positions, cfg.rope_theta)
        k = attn_lib.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp_half(cfg: LMConfig, p: Params, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's second half: norm, MLP or MoE, post-norm, residual."""
    x = L.apply_norm(cfg, p["norm2"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.moe is not None:
        y, aux = L.apply_moe(cfg, p["moe"], x)
    else:
        y = L.apply_mlp(cfg, p["mlp"], x)
    if cfg.post_norm:
        y = L.apply_norm(cfg, p["norm2_post"], y)
    return h + y, aux


def block_apply(
    cfg: LMConfig, p: Params, spec: AttnSpec, h: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. h: [B, S, D]. Returns (h, moe_aux)."""
    b, s, d = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    x = L.apply_norm(cfg, p["norm1"], h)
    q, k, v = _qkv(cfg, p, x, positions)
    o = attn_lib.attend(q, k, v, spec, attn_softcap=cfg.attn_softcap)
    o = o.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]
    if cfg.post_norm:
        o = L.apply_norm(cfg, p["norm1_post"], o)
    return _mlp_half(cfg, p, h + o)


def block_decode(
    cfg: LMConfig, p: Params, spec: AttnSpec, h: torch.Tensor, cache: KVCache, pos: int
) -> tuple[torch.Tensor, KVCache]:
    """Single-token block. h: [B, 1, D]; ``cache`` is updated in place."""
    b = h.shape[0]
    positions = torch.full((b, 1), pos, device=h.device)
    x = L.apply_norm(cfg, p["norm1"], h)
    q, k, v = _qkv(cfg, p, x, positions)
    o, cache = attn_lib.decode_attend(q, k, v, cache, pos, spec, attn_softcap=cfg.attn_softcap)
    o = o.reshape(b, 1, cfg.q_dim) @ p["attn"]["wo"]
    if cfg.post_norm:
        o = L.apply_norm(cfg, p["norm1_post"], o)
    h, _ = _mlp_half(cfg, p, h + o)
    return h, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def _pattern_split(cfg: LMConfig) -> tuple[int, int]:
    """(n_full_units, n_tail_slots)."""
    u = len(cfg.pattern)
    return cfg.n_layers // u, cfg.n_layers % u


def _stack(trees: list[Params]) -> Params:
    """Leaf-wise stack of equal trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_lm(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    """Random weights from ``gen`` (a generator on ``device``), in the
    reference's tree: ``embed``, ``blocks`` (``slotJ`` leaves stacked over
    the full units), ``tail`` (a list), ``final_norm`` and, untied,
    ``lm_head`` [n_codebooks, D, V].  The draws differ from the
    reference's; tests bridge its weights instead."""
    dtype = torch_dtype(cfg.dtype)
    n_units, n_tail = _pattern_split(cfg)
    units = [
        {f"slot{j}": _init_block(gen, cfg, spec, device) for j, spec in enumerate(cfg.pattern)}
        for _ in range(n_units)
    ]
    params: Params = {
        "blocks": _stack(units) if n_units else {},
        "tail": [_init_block(gen, cfg, cfg.pattern[j], device) for j in range(n_tail)],
        "embed": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device, scale=1.0),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.stack([
            _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
            for _ in range(cfg.n_codebooks)
        ])
    return params


# ---------------------------------------------------------------------------
# Whole-model forward paths
# ---------------------------------------------------------------------------


def _embed_in(cfg: LMConfig, params: Params, inputs: torch.Tensor) -> torch.Tensor:
    if not inputs.is_floating_point():
        h = params["embed"][inputs.long()]
    else:  # frontend stub: precomputed frame/patch embeddings [B, S, D]
        h = inputs.to(torch_dtype(cfg.dtype))
    if cfg.embed_scale:
        h = h * scalar(cfg.d_model**0.5, h)  # sqrt(d) rounded to the model's dtype
    return h


def _unit(cfg: LMConfig, params: Params, u: int) -> Params:
    """The parameters of full unit ``u`` (views into the stacked leaves)."""
    return tree_map(lambda x: x[u], params["blocks"])


def _unstack(blocks: Params) -> list[Params]:
    """Every entry of the stacked leaves' leading axis (a unit, or a layer)
    as views, one ``unbind`` a leaf: its backward is one stack, where a
    view a unit (``x[u]``) costs a zeros tensor of the whole stack a unit."""
    leaves = tree_leaves(blocks)
    if not leaves:
        return []
    split = [x.unbind(0) for x in leaves]
    return [tree_unflatten(blocks, [x[u] for x in split]) for u in range(len(split[0]))]


def lm_forward_hidden(
    cfg: LMConfig, params: Params, inputs: torch.Tensor, *, remat: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone only: final-normed hidden states [B, S, D] + moe aux."""
    n_units, n_tail = _pattern_split(cfg)
    h = _embed_in(cfg, params, inputs)

    def unit_fn(h, unit_p):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for j, spec in enumerate(cfg.pattern):
            h, a = block_apply(cfg, unit_p[f"slot{j}"], spec, h)
            aux = aux + a
        return h, aux

    recompute = remat and torch.is_grad_enabled()
    auxs = []
    for unit_p in _unstack(params["blocks"]):
        if recompute:
            h, a = checkpoint(unit_fn, h, unit_p, use_reentrant=False)
        else:
            h, a = unit_fn(h, unit_p)
        auxs.append(a)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    if n_units:
        aux_total = aux_total + torch.sum(torch.stack(auxs))
    for j in range(n_tail):
        h, a = block_apply(cfg, params["tail"][j], cfg.pattern[j], h)
        aux_total = aux_total + a
    return L.apply_norm(cfg, params["final_norm"], h), aux_total


def lm_head_logits(cfg: LMConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Project (already final-normed) hidden states to logits + softcap."""
    if cfg.tie_embeddings:
        logits = (h @ params["embed"].T)[..., None, :]
    else:
        logits = torch.einsum("bsd,ndv->bsnv", h, params["lm_head"])
    if cfg.logit_softcap > 0:
        cap = scalar(cfg.logit_softcap, logits)
        logits = cap * torch.tanh(logits / cap)
    if cfg.n_codebooks == 1:
        logits = logits[..., 0, :]
    return logits


def lm_forward(
    cfg: LMConfig, params: Params, inputs: torch.Tensor, *, remat: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward. Returns (logits [B,S,(N,)V], moe_aux_loss)."""
    h, aux_total = lm_forward_hidden(cfg, params, inputs, remat=remat)
    return lm_head_logits(cfg, params, h), aux_total


# -- serving ----------------------------------------------------------------


def init_cache(cfg: LMConfig, batch: int, max_len: int, device) -> Any:
    """KV caches mirroring the block structure (stacked over the units)."""
    dtype = torch_dtype(cfg.dtype)
    n_units, n_tail = _pattern_split(cfg)

    def one(spec: AttnSpec, lead: tuple = ()) -> KVCache:
        c = attn_lib.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim, spec,
                                   dtype, device)
        return KVCache(*(torch.zeros(lead + x.shape, dtype=dtype, device=device) for x in c))

    blocks = {
        f"slot{j}": one(spec, (n_units,)) for j, spec in enumerate(cfg.pattern)
    } if n_units else {}
    return {"blocks": blocks, "tail": [one(cfg.pattern[j]) for j in range(n_tail)]}


def lm_decode(
    cfg: LMConfig, params: Params, cache: Any, token: torch.Tensor, pos: int
) -> tuple[torch.Tensor, Any]:
    """One decode step. token: [B] int (or [B, D] embedding), pos: the
    token's position.  ``cache`` is updated in place and returned."""
    n_units, n_tail = _pattern_split(cfg)
    inputs = token[:, None] if token.ndim == 1 else token[:, None, :]
    h = _embed_in(cfg, params, inputs)
    for u in range(n_units):
        unit_p = _unit(cfg, params, u)
        for j, spec in enumerate(cfg.pattern):
            c = cache["blocks"][f"slot{j}"]
            h, _ = block_decode(cfg, unit_p[f"slot{j}"], spec, h, KVCache(c.k[u], c.v[u]), pos)
    for j in range(n_tail):
        h, _ = block_decode(cfg, params["tail"][j], cfg.pattern[j], h, cache["tail"][j], pos)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return lm_head_logits(cfg, params, h)[:, 0], cache


def lm_prefill(
    cfg: LMConfig, params: Params, inputs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill: returns last-position logits only (serving semantics)."""
    logits, _ = lm_forward(cfg, params, inputs)
    return logits[:, -1], torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# Partition specs
# ---------------------------------------------------------------------------


def _block_pspecs(cfg: LMConfig, model_size: int, fsdp_axis: str | None = "data") -> Params:
    """2D weight sharding: TP dims over "model", the d_model dim over the
    data axis (FSDP / ZeRO-3: per-device residency is P / (data * model))."""
    fs = fsdp_axis

    attn = {
        "wq": P(fs, "model"),
        "wk": P(fs, "model"),
        "wv": P(fs, "model"),
        "wo": P("model", fs),
    }
    if cfg.qk_norm:
        attn["q_norm"] = P(None)
        attn["k_norm"] = P(None)
    p: Params = {
        "norm1": {"scale": P(None)},
        "norm2": {"scale": P(None)},
        "attn": attn,
    }
    if cfg.norm == "layernorm":
        p["norm1"]["bias"] = P(None)
        p["norm2"]["bias"] = P(None)
    if cfg.post_norm:
        p["norm1_post"] = dict(p["norm1"])
        p["norm2_post"] = dict(p["norm2"])
    if cfg.moe is not None:
        ep = cfg.moe.num_experts % model_size == 0 and cfg.moe.shard_mode != "tp"
        if cfg.moe.shard_mode == "ep" and not ep:
            raise ValueError("EP requested but experts don't divide model axis")
        if ep:  # expert parallel: the experts over "model"
            p["moe"] = {
                "router": P(fs, None),
                "w_in": P("model", fs, None),
                "w_gate": P("model", fs, None),
                "w_out": P("model", None, fs),
            }
        else:  # tensor parallel: every expert's d_expert over "model"
            p["moe"] = {
                "router": P(fs, None),
                "w_in": P(None, fs, "model"),
                "w_gate": P(None, fs, "model"),
                "w_out": P(None, "model", fs),
            }
    else:
        p["mlp"] = {
            "w_in": P(fs, "model"),
            "w_out": P("model", fs),
        }
        if cfg.glu:
            p["mlp"]["w_gate"] = P(fs, "model")
    return p


def lm_pspecs(cfg: LMConfig, model_size: int, fsdp_axis: str | None = "data") -> Params:
    """Weight shardings, :func:`init_lm`'s tree leaf for leaf.
    ``fsdp_axis=None`` drops the ZeRO-3 dimension: weights replicate over
    the data axes (the serving layout, valid when TP-sharded params fit)."""
    n_units, n_tail = _pattern_split(cfg)
    bp = _block_pspecs(cfg, model_size, fsdp_axis)

    def add_leading(tree):
        return tree_map(lambda s: P(None, *s), tree, is_leaf=is_spec)

    vocab_ok = cfg.vocab_size % model_size == 0
    specs: Params = {
        "embed": P("model" if vocab_ok else None, fsdp_axis),
        "blocks": {f"slot{j}": add_leading(bp) for j in range(len(cfg.pattern))} if n_units else {},
        "tail": [bp for _ in range(n_tail)],
        "final_norm": {"scale": P(None)},
    }
    if cfg.norm == "layernorm":
        specs["final_norm"]["bias"] = P(None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, fsdp_axis, "model" if vocab_ok else None)
    return specs


def cache_pspecs(
    cfg: LMConfig,
    batch_axes: tuple[str, ...],
    seq_axis: str | None,
    model_size: int,
) -> Any:
    """Cache sharding, :func:`init_cache`'s tree: each [B, S, Hkv, Dh].

    Batch shards over the data axes; head_dim over "model" (KV head counts
    like 1 / 4 / 5 never divide a 16-way model axis, but every assigned
    head_dim does).  With ``seq_axis`` set, the sequence axis of *global*
    layers' caches shards over it.
    """
    n_units, n_tail = _pattern_split(cfg)
    dh_axis = "model" if cfg.head_dim % model_size == 0 else None

    def one(spec: AttnSpec, lead: bool) -> KVCache:
        seq = seq_axis if (spec.kind == "global" and seq_axis) else None
        batch = batch_axes if batch_axes else None
        # a mesh axis may appear only once per spec: when the sequence dim
        # takes "model" (flash-decoding layout), head_dim replicates
        dh = None if seq == "model" else dh_axis
        s = P(batch, seq, None, dh)
        if lead:
            s = P(None, *s)
        return KVCache(k=s, v=s)

    blocks = {
        f"slot{j}": one(spec, True) for j, spec in enumerate(cfg.pattern)
    } if n_units else {}
    tail = [one(cfg.pattern[j], False) for j in range(n_tail)]
    return {"blocks": blocks, "tail": tail}
