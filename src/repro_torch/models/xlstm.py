"""xLSTM (mLSTM-block) language model.

The port's copy of ``repro/models/xlstm.py``.  It runs off-mesh;
``xlstm_pspecs`` / ``state_pspecs`` give the reference's mesh layout for
the dry run.  The mLSTM
recurrence with exponential gating and max-stabilizer (Beck et al.,
arXiv:2405.04517):

    m_t = max(f~_t + m_{t-1}, i~_t)
    i_t = exp(i~_t - m_t);  f_t = exp(f~_t + m_{t-1} - m_t)
    C_t = f_t C_{t-1} + i_t (v_t k_t^T)        (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

Two execution forms compute the same outputs: ``chunk_size == 1`` is the
plain recurrence (single-token decode runs it), ``chunk_size > 1`` the
chunkwise-parallel form, quadratic gated attention inside a chunk and the
state carried between chunks.  The reference scans the chunks and the
layers with ``lax.scan``; here Python loops walk them, and ``remat=True``
recomputes each layer in the backward (``torch.utils.checkpoint``).

Precision is the reference's: q, k and v in ``cfg.dtype``, the gates, the
chunk's math and the state in float32, the cell's output cast back to
``cfg.dtype`` before ``out_norm``.  The parameter tree is the reference's
leaf for leaf: ``blocks`` stacked on a leading layer axis, ``lm_head`` a
[D, V] matrix.  Decode writes the state in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.sharding import P
from repro_torch.common.tree import tree_map
from repro_torch.common.types import LMConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import _dense_init, torch_dtype
from repro_torch.models.transformer import _stack, _unstack

Params = dict[str, Any]


class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, Dk, Dv]
    n: torch.Tensor  # [B, H, Dk]
    m: torch.Tensor  # [B, H]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _inner(cfg: LMConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _init_block(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    d, inner, h = cfg.d_model, _inner(cfg), cfg.n_heads
    f32 = torch.float32
    return {
        "norm": L.init_norm(cfg, d, device),
        "wq": _dense_init(gen, (d, inner), dtype, device),
        "wk": _dense_init(gen, (d, inner), dtype, device),
        "wv": _dense_init(gen, (d, inner), dtype, device),
        "w_igate": _dense_init(gen, (d, h), f32, device),
        "w_fgate": _dense_init(gen, (d, h), f32, device),
        "b_fgate": torch.full((h,), 3.0, dtype=f32, device=device),  # open forget gates
        "b_igate": torch.zeros((h,), dtype=f32, device=device),
        "w_ogate": _dense_init(gen, (d, inner), dtype, device),
        "w_down": _dense_init(gen, (inner, d), dtype, device),
        "out_norm": L.init_norm(cfg, inner, device),
    }


def init_xlstm(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    """Random weights from ``gen`` (a generator on ``device``) in the
    reference's tree.  The draws differ from the reference's; tests bridge
    its weights instead."""
    dtype = torch_dtype(cfg.dtype)
    return {
        "embed": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device, scale=1.0),
        "blocks": _stack([_init_block(gen, cfg, device) for _ in range(cfg.n_layers)]),
        "final_norm": L.init_norm(cfg, cfg.d_model, device),
        "lm_head": _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device),
    }


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------


def _mlstm_chunk(q, k, v, ig, fg, state: MLSTMState):
    """One chunk. q,k,v: [B, H, C, Dh]; ig,fg: [B, H, C] (raw logits)."""
    b, h, cn, dh = q.shape
    logf = F.logsigmoid(fg)  # [B,H,C]
    bcum = torch.cumsum(logf, dim=-1)  # cumulative log-forget within chunk

    # stabilizer: candidate maxima from inter (m_prev + bcum) and intra terms;
    # amax splits a tie's gradient evenly, as JAX's reduce-max does
    intra_log = bcum[..., :, None] - bcum[..., None, :] + ig[..., None, :]  # [B,H,C,C]
    tri = torch.tril(torch.ones((cn, cn), dtype=torch.bool, device=q.device))
    intra_log = torch.where(tri, intra_log, -torch.inf)
    m_intra = torch.amax(intra_log, dim=-1)  # [B,H,C]
    m_t = torch.maximum(state.m[..., None] + bcum, m_intra)  # [B,H,C]

    scale = dh ** -0.5
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()

    # intra-chunk gated attention
    gates = torch.exp(intra_log - m_t[..., None])
    s_mat = torch.einsum("bhtd,bhsd->bhts", qf, kf) * gates
    h_intra = torch.einsum("bhts,bhsd->bhtd", s_mat, vf)
    n_intra = torch.einsum("bhts,bhsd->bhtd", gates, kf)

    # inter-chunk contribution from carried state
    decay_in = torch.exp(state.m[..., None] + bcum - m_t)  # [B,H,C]
    h_inter = torch.einsum("bhtd,bhde->bhte", qf, state.c) * decay_in[..., None]
    n_inter = state.n[:, :, None, :] * decay_in[..., None]

    n_t = n_intra + n_inter
    h_num = h_intra + h_inter
    denom = torch.maximum(
        torch.abs(torch.einsum("bhtd,bhtd->bht", n_t, qf)), torch.exp(-m_t)
    )
    out = h_num / denom[..., None]

    # end-of-chunk state update, recomputed in the m_end frame
    m_end = torch.maximum(state.m + bcum[..., -1], torch.amax(intra_log[..., -1, :], dim=-1))
    w_end = torch.exp(bcum[..., -1:] - bcum + ig - m_end[..., None])  # [B,H,C]
    carry = torch.exp(state.m + bcum[..., -1] - m_end)
    c_new = carry[..., None, None] * state.c + torch.einsum(
        "bhs,bhsd,bhse->bhde", w_end, kf, vf
    )
    n_new = carry[..., None] * state.n + torch.einsum("bhs,bhsd->bhd", w_end, kf)
    return out, MLSTMState(c=c_new, n=n_new, m=m_end)


def mlstm_sequence(q, k, v, ig, fg, state: MLSTMState, chunk_size: int):
    """q,k,v: [B, H, S, Dh]; ig/fg: [B, H, S]. Returns ([B,H,S,Dh], state)."""
    s = q.shape[2]
    cn = min(chunk_size, s)
    assert s % cn == 0, f"seq {s} % chunk {cn}"
    outs = []
    for c0 in range(0, s, cn):
        out, state = _mlstm_chunk(*(x[:, :, c0:c0 + cn] for x in (q, k, v, ig, fg)), state)
        outs.append(out)
    return torch.cat(outs, dim=2), state


# ---------------------------------------------------------------------------
# block / model forward
# ---------------------------------------------------------------------------


def _block_qkvg(cfg: LMConfig, p: Params, x: torch.Tensor):
    b, s, _ = x.shape
    h, inner = cfg.n_heads, _inner(cfg)
    dh = inner // h
    z = L.apply_norm(cfg, p["norm"], x)

    def heads(t):
        return t.reshape(b, s, h, dh).transpose(1, 2)  # [B,H,S,Dh]

    q, k, v = heads(z @ p["wq"]), heads(z @ p["wk"]), heads(z @ p["wv"])
    zf = z.float()
    ig = (zf @ p["w_igate"] + p["b_igate"]).transpose(1, 2)  # [B,H,S]
    fg = (zf @ p["w_fgate"] + p["b_fgate"]).transpose(1, 2)
    gate = L.act_fn("silu")(z @ p["w_ogate"])
    return z, q, k, v, ig, fg, gate


def _block_out(cfg: LMConfig, p: Params, x, out, gate):
    """The cell's output [B, H, S, Dh] back to the residual stream."""
    b, s = x.shape[:2]
    out = out.transpose(1, 2).reshape(b, s, _inner(cfg)).to(x.dtype)
    out = L.apply_norm(cfg, p["out_norm"], out) * gate
    return x + out @ p["w_down"]


def _zero_state(cfg: LMConfig, lead: tuple, device) -> MLSTMState:
    h = cfg.n_heads
    dh = _inner(cfg) // h
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros(lead + (h, dh, dh), dtype=f32, device=device),
        n=torch.zeros(lead + (h, dh), dtype=f32, device=device),
        m=torch.full(lead + (h,), -1e30, dtype=f32, device=device),
    )


def block_apply(cfg: LMConfig, p: Params, x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    _, q, k, v, ig, fg, gate = _block_qkvg(cfg, p, x)
    out, _ = mlstm_sequence(q, k, v, ig, fg, _zero_state(cfg, (x.shape[0],), x.device),
                            chunk_size)
    return _block_out(cfg, p, x, out, gate)


def _block_step_inner(cfg: LMConfig, p: Params, x, state: MLSTMState):
    _, q, k, v, ig, fg, gate = _block_qkvg(cfg, p, x)
    out, state = _mlstm_chunk(q, k, v, ig, fg, state)
    return _block_out(cfg, p, x, out, gate), state


def block_decode(cfg: LMConfig, p: Params, x: torch.Tensor, state: MLSTMState):
    """x: [B, 1, D]."""
    return _block_step_inner(cfg, p, x, state)


def _embed_in(cfg: LMConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    if not tokens.is_floating_point():
        return params["embed"][tokens.long()]
    return tokens.to(torch_dtype(cfg.dtype))


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters (views into the stacked leaves)."""
    return tree_map(lambda x: x[i], params["blocks"])


def xlstm_forward_hidden(cfg: LMConfig, params: Params, tokens: torch.Tensor, *,
                         chunk_size: int = 256, remat: bool = False):
    h = _embed_in(cfg, params, tokens)
    recompute = remat and torch.is_grad_enabled()
    for p in _unstack(params["blocks"]):
        if recompute:
            h = checkpoint(block_apply, cfg, p, h, chunk_size, use_reentrant=False)
        else:
            h = block_apply(cfg, p, h, chunk_size)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def xlstm_head_logits(cfg: LMConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    return h @ params["lm_head"]


def xlstm_forward(cfg: LMConfig, params: Params, tokens: torch.Tensor, *,
                  chunk_size: int = 256, remat: bool = False):
    h, aux = xlstm_forward_hidden(cfg, params, tokens, chunk_size=chunk_size, remat=remat)
    return xlstm_head_logits(cfg, params, h), aux


def init_state(cfg: LMConfig, batch: int, device) -> MLSTMState:
    """Every layer's state, stacked on a leading layer axis."""
    return _zero_state(cfg, (cfg.n_layers, batch), device)


def xlstm_decode(cfg: LMConfig, params: Params, state: MLSTMState, token: torch.Tensor, pos):
    """One decode step; ``state`` is updated in place and returned.  The
    position is implicit in the state, so ``pos`` is unused."""
    del pos
    h = (params["embed"][token.long()][:, None, :] if token.ndim == 1
         else token[:, None, :].to(torch_dtype(cfg.dtype)))
    for i in range(cfg.n_layers):
        h, st = _block_step_inner(cfg, _layer(params, i), h,
                                  MLSTMState(*(x[i] for x in state)))
        for dst, src in zip(state, st):
            dst[i].copy_(src)
    h = L.apply_norm(cfg, params["final_norm"], h)
    return (h @ params["lm_head"])[:, 0], state


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------


def xlstm_pspecs(cfg: LMConfig, model_size: int, fsdp_axis: str | None = "data") -> Params:
    """Weight shardings, :func:`init_xlstm`'s tree leaf for leaf."""
    inner_ok = _inner(cfg) % model_size == 0
    m = "model" if inner_ok else None
    vocab_ok = cfg.vocab_size % model_size == 0
    fs = fsdp_axis  # FSDP axis for the d_model dim (2D weight sharding)
    blk = {
        "norm": {"scale": P(None, None)},
        "wq": P(None, fs, m),
        "wk": P(None, fs, m),
        "wv": P(None, fs, m),
        "w_igate": P(None, fs, None),
        "w_fgate": P(None, fs, None),
        "b_fgate": P(None, None),
        "b_igate": P(None, None),
        "w_ogate": P(None, fs, m),
        "w_down": P(None, m, fs),
        "out_norm": {"scale": P(None, None)},
    }
    if cfg.norm == "layernorm":
        blk["norm"]["bias"] = P(None, None)
        blk["out_norm"]["bias"] = P(None, None)
    return {
        "embed": P("model" if vocab_ok else None, fs),
        "blocks": blk,
        "final_norm": {"scale": P(None)} | ({"bias": P(None)} if cfg.norm == "layernorm" else {}),
        "lm_head": P(fs, "model" if vocab_ok else None),
    }


def state_pspecs(cfg: LMConfig, batch_axes: tuple[str, ...], model_size: int) -> MLSTMState:
    """State sharding, :func:`init_state`'s tree: batch over the data axes."""
    b = batch_axes if batch_axes else None
    return MLSTMState(
        c=P(None, b, None, None, None),
        n=P(None, b, None, None),
        m=P(None, b, None),
    )
