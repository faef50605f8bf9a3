"""PAS-inspired layer skipping for autoregressive LM decode (beyond-paper).

The port's copy of ``repro/core/lm_skip.py``.  Between adjacent tokens the
contribution of the middle layer stack (its residual delta) is more stable
than the token stream itself, so decode reuses it, refreshed every
``refresh_every`` steps:

* FULL step (``pos % refresh_every == 0``): run all units, record the
  middle stack's residual delta  Δ = h_after_mid − h_before_mid.
* SKIP step: run the front / back units and the tail normally; replace
  the middle stack with ``h += Δ``.  A write-through pass keeps the
  middle layers' KV caches coherent: their (k, v) projections of the
  approximated hidden state are written at the current position
  (~2·d·kv_dim FLOPs per layer instead of the full ~12·d² block), so the
  next FULL step attends over a gap-free cache.

The reference picks the branch with ``lax.cond`` on a traced position; here
the position is a Python int and the branch a Python ``if``.  The caches
are written in place.  Only the transformer family is supported: the
recurrent ``ssm`` / ``hybrid`` families raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.types import LMConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import torch_dtype

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SkipPlan:
    """{front, back, refresh_every} — the LM analogue of
    {L_sketch/L_refine, T_sparse}."""

    front: int  # leading units always executed
    back: int  # trailing units always executed
    refresh_every: int  # full run period (the paper's T_sparse)

    def validate(self, n_units: int):
        if self.front + self.back >= n_units:
            raise ValueError("front+back must leave a non-empty middle stack")
        if min(self.front, self.back) < 1:
            raise ValueError("keep at least one unit at each end (paper: "
                             "L_refine >= outlier blocks at BOTH ends matters for LMs)")
        if self.refresh_every < 2:
            raise ValueError("refresh_every < 2 never skips")


def _check_family(cfg: LMConfig):
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: layer skipping supports the transformer family only, "
                         f"not the {cfg.family!r} family")


def _unit_cache(cache_blocks: dict, j: int, u: int) -> KVCache:
    c = cache_blocks[f"slot{j}"]
    return KVCache(c.k[u], c.v[u])


def _run_range(cfg: LMConfig, params: Params, cache_blocks: dict, h, pos: int, a: int, b: int):
    """Decode units [a, b), their caches written in place."""
    for u in range(a, b):
        unit_p = T._unit(cfg, params, u)
        for j, spec in enumerate(cfg.pattern):
            h, _ = T.block_decode(cfg, unit_p[f"slot{j}"], spec, h,
                                  _unit_cache(cache_blocks, j, u), pos)
    return h


def _kv_writethrough(cfg: LMConfig, params: Params, cache_blocks: dict, h, pos: int,
                     a: int, b: int):
    """Write (k, v) of units [a, b), all from the same approximated hidden
    state ``h``, so skipped layers leave no cache gaps.  No attention or
    MLP compute; k is normed and rotated as the block would, q is not
    computed."""
    bsz = h.shape[0]
    positions = torch.full((bsz, 1), pos, device=h.device)
    for u in range(a, b):
        unit_p = T._unit(cfg, params, u)
        for j, spec in enumerate(cfg.pattern):
            p = unit_p[f"slot{j}"]
            c = _unit_cache(cache_blocks, j, u)
            x = L.apply_norm(cfg, p["norm1"], h)
            k = (x @ p["attn"]["wk"]).reshape(bsz, 1, cfg.n_kv_heads, cfg.head_dim)
            v = (x @ p["attn"]["wv"]).reshape(bsz, 1, cfg.n_kv_heads, cfg.head_dim)
            if cfg.qk_norm:
                k = T._rms_head(k, p["attn"]["k_norm"])
            if cfg.use_rope:
                k = attn_lib.apply_rope(k, positions, cfg.rope_theta)
            ring = spec.kind == "local" and c.length == spec.window
            slot = pos % c.length if ring else min(pos, c.length - 1)  # JAX clamps
            c.k[:, slot] = k[:, 0]
            c.v[:, slot] = v[:, 0]


def init_skip_state(cfg: LMConfig, batch: int, max_len: int, device) -> dict:
    _check_family(cfg)
    return {
        "cache": T.init_cache(cfg, batch, max_len, device),
        "delta": torch.zeros((batch, 1, cfg.d_model), dtype=torch_dtype(cfg.dtype),
                             device=device),
    }


def skip_decode(
    cfg: LMConfig,
    params: Params,
    state: dict,
    token: torch.Tensor,
    pos: int,
    plan: SkipPlan,
) -> tuple[torch.Tensor, dict]:
    """One decode step under the skip plan.  Matches ``lm_decode``'s
    signature modulo the extra plan / state; the state's caches are
    updated in place."""
    _check_family(cfg)
    n_units, n_tail = T._pattern_split(cfg)
    plan.validate(n_units)
    a, b = plan.front, n_units - plan.back

    inputs = token[:, None] if token.ndim == 1 else token[:, None, :]
    h = T._embed_in(cfg, params, inputs)
    cache = state["cache"]
    blocks_c = cache["blocks"]

    # front units always run
    h = _run_range(cfg, params, blocks_c, h, pos, 0, a)
    if pos % plan.refresh_every == 0:  # FULL middle: run it, record its delta
        h_in = h
        h = _run_range(cfg, params, blocks_c, h, pos, a, b)
        delta = (h - h_in).to(state["delta"].dtype)
    else:  # SKIP middle: reuse the delta, write the middle's K/V through
        h = h + state["delta"]
        _kv_writethrough(cfg, params, blocks_c, h, pos, a, b)
        delta = state["delta"]

    # back units + tail always run
    h = _run_range(cfg, params, blocks_c, h, pos, b, n_units)
    for j in range(n_tail):
        h, _ = T.block_decode(cfg, params["tail"][j], cfg.pattern[j], h, cache["tail"][j], pos)

    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = T.lm_head_logits(cfg, params, h)[:, 0]
    return logits, {"cache": cache, "delta": delta}


def flops_reduction(cfg: LMConfig, plan: SkipPlan) -> float:
    """Analytic per-token FLOP reduction (attention ignored, like Eq. 3)."""
    n_units, _ = T._pattern_split(cfg)
    d = cfg.d_model
    per_block = 2 * d * (cfg.q_dim + 2 * cfg.kv_dim + cfg.q_dim) + 2 * 3 * d * cfg.d_ff
    writethrough = 2 * d * 2 * cfg.kv_dim
    mid = n_units - plan.front - plan.back
    full_cost = n_units * per_block
    skip_cost = (n_units - mid) * per_block + mid * writethrough
    k = plan.refresh_every
    avg = (full_cost + (k - 1) * skip_cost) / k
    return full_cost / avg
