"""Attention of the LM transformer family: GQA, RoPE, sliding windows,
softcaps.  The port's copy of ``repro/models/attention.py``.

Two paths:

* ``attend``: full-sequence attention for train and prefill; one shot for
  ``s <= q_chunk``, else query chunks of ``q_chunk`` rows (each chunk's
  float32 scores are ``[B, H, q_chunk, S]``), each chunk recomputed in the
  backward (``torch.utils.checkpoint``) when a gradient is wanted.
* ``decode_attend``: one query against a KV cache, a ring buffer for
  sliding-window layers and a linear buffer for global ones.

Both keep the reference's precision, and the two differ: full-sequence
scores multiply bf16 q and k into a float32 product (``jnp.einsum(...,
preferred_element_type=float32)``: here the exact float32 upcast of both
operands), while decode scores are computed in the operands' dtype and
then cast to float32.  Plain einsum and softmax on tensors:
``F.scaled_dot_product_attention`` has no softcap and reorders the math.
No kernel of ``repro_torch.kernels`` runs here, as no Pallas kernel runs
on the reference's LM path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.types import AttnSpec
from repro_torch.models.layers import scalar

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)  # a float32 power: theta rounded to float32, as in JAX


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable).  Computed in
    float32 and cast back to ``x``'s dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [Dh/2]
    ang = positions[..., None].float() * freqs  # [..., S, Dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def _scale_q(q: torch.Tensor) -> torch.Tensor:
    """``q * head_dim ** -0.5`` with the scale rounded to ``q``'s dtype
    first, as JAX rounds the Python float (exact only where head_dim is a
    power of 4)."""
    return q * scalar(q.shape[-1] ** -0.5, q)


# ---------------------------------------------------------------------------
# Full-sequence attention (train / prefill)
# ---------------------------------------------------------------------------


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    m = k_pos[None, :] <= q_pos[:, None]  # causal
    if window > 0:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def adaptive_q_chunk(s_len: int) -> int:
    """The chunk ``attend`` picks when given none: about 2**21 score
    entries a chunk row block, between 128 and 1024 rows, halved until it
    divides the sequence."""
    q_chunk = max(128, min(1024, 2**21 // max(s_len, 1)))
    while s_len % q_chunk:
        q_chunk //= 2
    return q_chunk


def _attend_block(qc, k, v, q_pos, k_pos, window: int, attn_softcap: float):
    """One block of query rows. qc: [B, C, Hkv, rep, Dh] (scaled)."""
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qc.float(), k.float())
    logits = _softcap(logits, attn_softcap)
    m = _mask(q_pos, k_pos, window)
    logits = torch.where(m[None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", w, v)


def attend(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    spec: AttnSpec,
    *,
    attn_softcap: float = 0.0,
    q_chunk: int = 0,  # 0 -> adaptive_q_chunk(S)
) -> torch.Tensor:
    if q_chunk == 0:
        q_chunk = adaptive_q_chunk(q.shape[1])
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    window = spec.window if spec.kind == "local" else 0

    qh = _scale_q(q).reshape(b, s, hkv, rep, dh)
    positions = torch.arange(s, device=q.device)

    if s <= q_chunk:
        out = _attend_block(qh, k, v, positions, positions, window, attn_softcap)
        return out.reshape(b, s, h, dh)

    # query-chunked: the float32 scores exist for one chunk at a time
    if s % q_chunk:
        raise ValueError(f"seq {s} not divisible by q_chunk {q_chunk}")
    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for c0 in range(0, s, q_chunk):
        args = (qh[:, c0:c0 + q_chunk], k, v, positions[c0:c0 + q_chunk], positions,
                window, attn_softcap)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False) if recompute
                    else _attend_block(*args))
    return torch.cat(outs, dim=1).reshape(b, s, h, dh)


# ---------------------------------------------------------------------------
# Decode path with KV caches
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer cache.  ``k``/``v``: [B, S_cache, Hkv, Dh].

    For sliding-window layers ``S_cache == window`` and the buffer is a ring
    indexed by ``pos % window``; for global layers ``S_cache == max_len``.
    """

    k: torch.Tensor
    v: torch.Tensor

    @property
    def length(self) -> int:
        return self.k.shape[1]


def init_kv_cache(
    batch: int, max_len: int, n_kv: int, head_dim: int, spec: AttnSpec, dtype, device
) -> KVCache:
    s_cache = min(spec.window, max_len) if spec.kind == "local" else max_len
    shape = (batch, s_cache, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def cache_positions(cache_len: int, pos: int, ring: bool, device="cpu") -> torch.Tensor:
    """Absolute position stored at each cache slot (-1 => empty)."""
    idx = torch.arange(cache_len, device=device)
    if not ring:
        return torch.where(idx <= pos, idx, -1)
    # ring slot i holds the most recent position p <= pos with p % W == i
    p = pos - ((pos - idx) % cache_len)
    return torch.where(p >= 0, p, -1)


def decode_attend(
    q: torch.Tensor,  # [B, 1, H, Dh] (already rotated)
    k_new: torch.Tensor,  # [B, 1, Hkv, Dh] (already rotated)
    v_new: torch.Tensor,
    cache: KVCache,
    pos: int,  # index of the new token
    spec: AttnSpec,
    *,
    attn_softcap: float = 0.0,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  The new k / v are written into ``cache`` in place
    (slot ``pos % window`` of a ring, ``pos`` of a linear cache), and the
    same cache is returned."""
    b, _, h, dh = q.shape
    hkv = k_new.shape[2]
    rep = h // hkv
    ring = spec.kind == "local" and cache.length == spec.window
    slot = pos % cache.length if ring else min(pos, cache.length - 1)  # JAX clamps

    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]

    kpos = cache_positions(cache.length, pos, ring, q.device)
    valid = kpos >= 0
    if spec.kind == "local":
        valid = valid & (kpos > pos - spec.window)
    valid = valid & (kpos <= pos)

    qh = _scale_q(q).reshape(b, 1, hkv, rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qh, cache.k).float()
    logits = _softcap(logits, attn_softcap)
    logits = torch.where(valid[None, None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(cache.v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, cache.v).reshape(b, 1, h, dh)
    return out, cache
