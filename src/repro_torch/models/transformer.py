"""Decoder-only LM transformer for the dense, moe, audio and vlm families.

The port's copy of ``repro/models/transformer.py``, off-mesh.  The layer
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

from repro_torch.common.tree import tree_map
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
    for u in range(n_units):
        unit_p = _unit(cfg, params, u)
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
