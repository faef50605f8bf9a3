"""Hymba-style hybrid-head model: parallel attention + Mamba(SSM) heads.

The port's copy of ``repro/models/hymba.py``.  It runs off-mesh;
``hymba_pspecs`` / ``cache_pspecs`` give the reference's mesh layout for
the dry run.  Each layer
computes sliding-window GQA attention and a selective SSM (Mamba-1 style,
state size ``cfg.ssm_state``) over the same normed input, averages the two
paths (arXiv:2411.13676), then applies a gated FFN.  Every layer uses the
window ``HYMBA_WINDOW``, whatever the config's ``pattern`` says.

The reference scans the layers and the selective scan's time steps with
``lax.scan``; here Python loops walk both, with the scan's ``da`` / ``dbx``
in float32 as in the reference, and ``remat=True`` recomputes each layer
in the backward (``torch.utils.checkpoint``).  The attention is the
transformer family's (``attention.attend`` / ``decode_attend``).  The
parameter tree is the reference's leaf for leaf; decode writes the caches
in place, so every layer's cache is its own storage.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.sharding import P
from repro_torch.common.types import AttnSpec, LMConfig, local
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import _dense_init, torch_dtype
from repro_torch.models.transformer import _stack, _unstack
from repro_torch.models.xlstm import _embed_in, _layer

Params = dict[str, Any]

HYMBA_WINDOW = 1024


class SSMState(NamedTuple):
    conv: torch.Tensor  # [B, K-1, inner] rolling conv buffer
    h: torch.Tensor  # [B, inner, N] ssm state


class HymbaCache(NamedTuple):
    kv: KVCache
    ssm: SSMState


def _inner(cfg: LMConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _spec(cfg: LMConfig) -> AttnSpec:
    return local(HYMBA_WINDOW)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(gen: torch.Generator, cfg: LMConfig, device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    d, inner, n = cfg.d_model, _inner(cfg), cfg.ssm_state
    dt_rank = max(d // 16, 8)
    f32 = torch.float32
    return {
        "norm1": L.init_norm(cfg, d, device),
        "norm2": L.init_norm(cfg, d, device),
        "attn": {
            "wq": _dense_init(gen, (d, cfg.q_dim), dtype, device),
            "wk": _dense_init(gen, (d, cfg.kv_dim), dtype, device),
            "wv": _dense_init(gen, (d, cfg.kv_dim), dtype, device),
            "wo": _dense_init(gen, (cfg.q_dim, d), dtype, device),
        },
        "ssm": {
            "w_in": _dense_init(gen, (d, 2 * inner), dtype, device),
            "conv_w": _dense_init(gen, (cfg.ssm_conv, inner), dtype, device, scale=0.5),
            "conv_b": torch.zeros((inner,), dtype=dtype, device=device),
            "w_xdb": _dense_init(gen, (inner, dt_rank + 2 * n), dtype, device),
            "w_dt": _dense_init(gen, (dt_rank, inner), f32, device),
            "b_dt": torch.full((inner,), -4.6, dtype=f32, device=device),  # softplus^-1(0.01)
            "a_log": torch.log(torch.arange(1, n + 1, dtype=f32, device=device).repeat(inner, 1)),
            "d_skip": torch.ones((inner,), dtype=f32, device=device),
            "w_out": _dense_init(gen, (inner, d), dtype, device),
        },
        "attn_norm": L.init_norm(cfg, d, device),
        "ssm_norm": L.init_norm(cfg, d, device),
        "mlp": L.init_mlp(gen, cfg, device),
    }


def init_hymba(gen: torch.Generator, cfg: LMConfig, device) -> Params:
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
# Mamba path
# ---------------------------------------------------------------------------


def _ssm_scan(p: Params, xc: torch.Tensor, h0: torch.Tensor):
    """Selective scan. xc: [B, S, inner] (post-conv, post-act).

    Returns y [B, S, inner] and final state [B, inner, N].
    """
    n = p["a_log"].shape[1]
    dt_rank = p["w_xdb"].shape[1] - 2 * n
    xdb = xc @ p["w_xdb"]
    dt_in, bmat, cmat = torch.split(xdb, [dt_rank, n, n], dim=-1)
    # linear above 20 where JAX's logaddexp is not: equal within float32 there
    dt = F.softplus(dt_in.float() @ p["w_dt"] + p["b_dt"], beta=1, threshold=20)  # [B,S,inner]
    a = -torch.exp(p["a_log"])  # [inner, N]

    da = torch.exp(dt[..., None] * a)  # [B,S,inner,N]
    dbx = dt[..., None] * bmat[..., None, :].float() * xc[..., None].float()
    cf = cmat.float()

    # one step a position: unbind's backward is one stack (a select's is a
    # [B, S, inner, N] zeros tensor a step), and the bmm is the very product
    # einsum("bin,bn->bi") dispatches, without its eight views
    h, ys = h0, []
    for da_t, dbx_t, c_t in zip(da.unbind(1), dbx.unbind(1), cf.unbind(1)):
        h = da_t * h + dbx_t
        ys.append(torch.bmm(h, c_t.unsqueeze(2))[..., 0])
    y = torch.stack(ys, dim=1) + xc.float() * p["d_skip"]
    return y.to(xc.dtype), h


def _causal_conv(p: Params, x: torch.Tensor, buf: torch.Tensor | None):
    """Depthwise causal conv, kernel K. x: [B,S,inner].  The taps sum in
    ``x``'s dtype, one rounding per tap, as in the reference."""
    k = p["conv_w"].shape[0]
    if buf is None:
        buf = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([buf, x], dim=1)  # [B, S+K-1, inner]
    out = sum(xp[:, i : i + x.shape[1], :] * p["conv_w"][i] for i in range(k))
    new_buf = xp[:, -(k - 1) :, :]
    return out + p["conv_b"], new_buf


def ssm_path(cfg: LMConfig, p: Params, z: torch.Tensor, state: SSMState | None):
    b = z.shape[0]
    silu = L.act_fn("silu")
    xz = z @ p["w_in"]
    x_part, gate = torch.chunk(xz, 2, dim=-1)
    x_conv, new_buf = _causal_conv(p, x_part, None if state is None else state.conv)
    xc = silu(x_conv)
    h0 = (torch.zeros((b, _inner(cfg), cfg.ssm_state), dtype=torch.float32, device=z.device)
          if state is None else state.h)
    y, h_fin = _ssm_scan(p, xc, h0)
    y = y * silu(gate)
    out = y @ p["w_out"]
    return out, SSMState(conv=new_buf, h=h_fin)


# ---------------------------------------------------------------------------
# block / model forward
# ---------------------------------------------------------------------------


def _qkv(cfg: LMConfig, p: Params, z: torch.Tensor, positions: torch.Tensor):
    b, s, _ = z.shape
    q = (z @ p["attn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (z @ p["attn"]["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (z @ p["attn"]["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = attn_lib.apply_rope(q, positions, cfg.rope_theta)
    k = attn_lib.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _fuse(cfg: LMConfig, p: Params, h, ao, so):
    """Average the normed attention and SSM paths, then the gated FFN."""
    fused = 0.5 * (
        L.apply_norm(cfg, p["attn_norm"], ao) + L.apply_norm(cfg, p["ssm_norm"], so)
    )
    h = h + fused
    return h + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], h))


def block_apply(cfg: LMConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    b, s, _ = h.shape
    z = L.apply_norm(cfg, p["norm1"], h)
    q, k, v = _qkv(cfg, p, z, torch.arange(s, device=h.device).expand(b, s))
    ao = attn_lib.attend(q, k, v, _spec(cfg)).reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]
    so, _ = ssm_path(cfg, p["ssm"], z, None)
    return _fuse(cfg, p, h, ao, so)


def block_decode(cfg: LMConfig, p: Params, h: torch.Tensor, cache: HymbaCache, pos: int):
    """Single-token block. h: [B, 1, D]; ``cache`` is updated in place."""
    b = h.shape[0]
    z = L.apply_norm(cfg, p["norm1"], h)
    q, k, v = _qkv(cfg, p, z, torch.full((b, 1), pos, device=h.device))
    ao, kv = attn_lib.decode_attend(q, k, v, cache.kv, pos, _spec(cfg))
    ao = ao.reshape(b, 1, cfg.q_dim) @ p["attn"]["wo"]

    so, ssm_state = ssm_path(cfg, p["ssm"], z, cache.ssm)
    cache.ssm.conv.copy_(ssm_state.conv)
    cache.ssm.h.copy_(ssm_state.h)
    return _fuse(cfg, p, h, ao, so), HymbaCache(kv=kv, ssm=cache.ssm)


def hymba_forward_hidden(cfg: LMConfig, params: Params, tokens: torch.Tensor, *,
                         remat: bool = False):
    h = _embed_in(cfg, params, tokens)
    recompute = remat and torch.is_grad_enabled()
    for p in _unstack(params["blocks"]):
        h = (checkpoint(block_apply, cfg, p, h, use_reentrant=False) if recompute
             else block_apply(cfg, p, h))
    h = L.apply_norm(cfg, params["final_norm"], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def hymba_head_logits(cfg: LMConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    return h @ params["lm_head"]


def hymba_forward(cfg: LMConfig, params: Params, tokens: torch.Tensor, *, remat: bool = False):
    h, aux = hymba_forward_hidden(cfg, params, tokens, remat=remat)
    return hymba_head_logits(cfg, params, h), aux


def init_cache(cfg: LMConfig, batch: int, max_len: int, device) -> HymbaCache:
    """Every layer's cache, stacked on a leading layer axis.  Each layer
    has its own zeros (the reference broadcasts one immutable cache; decode
    here writes in place)."""
    dtype = torch_dtype(cfg.dtype)
    inner = _inner(cfg)
    kv = attn_lib.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim, _spec(cfg),
                                dtype, device)
    lead = (cfg.n_layers,)
    return HymbaCache(
        kv=KVCache(*(torch.zeros(lead + x.shape, dtype=dtype, device=device) for x in kv)),
        ssm=SSMState(
            conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, inner), dtype=dtype,
                             device=device),
            h=torch.zeros(lead + (batch, inner, cfg.ssm_state), dtype=torch.float32,
                          device=device),
        ),
    )


def _layer_cache(cache: HymbaCache, i: int) -> HymbaCache:
    return HymbaCache(kv=KVCache(cache.kv.k[i], cache.kv.v[i]),
                      ssm=SSMState(cache.ssm.conv[i], cache.ssm.h[i]))


def hymba_decode(cfg: LMConfig, params: Params, cache: HymbaCache, token: torch.Tensor, pos):
    """One decode step; ``cache`` is updated in place and returned."""
    h = (params["embed"][token.long()][:, None, :] if token.ndim == 1
         else token[:, None, :].to(torch_dtype(cfg.dtype)))
    for i in range(cfg.n_layers):
        h, _ = block_decode(cfg, _layer(params, i), h, _layer_cache(cache, i), int(pos))
    h = L.apply_norm(cfg, params["final_norm"], h)
    return (h @ params["lm_head"])[:, 0], cache


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------


def hymba_pspecs(cfg: LMConfig, model_size: int, fsdp_axis: str | None = "data") -> Params:
    """Weight shardings, :func:`init_hymba`'s tree leaf for leaf."""
    inner = _inner(cfg)
    m = "model" if inner % model_size == 0 else None
    qm = "model" if cfg.q_dim % model_size == 0 else None
    kvm = "model" if cfg.kv_dim % model_size == 0 else None
    fm = "model" if cfg.d_ff % model_size == 0 else None
    vocab_ok = cfg.vocab_size % model_size == 0
    fs = fsdp_axis  # FSDP axis for the d_model dim (2D weight sharding)

    def norm():
        return {"scale": P(None, None)} | (
            {"bias": P(None, None)} if cfg.norm == "layernorm" else {})

    blk = {
        "norm1": norm(),
        "norm2": norm(),
        "attn": {
            "wq": P(None, fs, qm),
            "wk": P(None, fs, kvm),
            "wv": P(None, fs, kvm),
            "wo": P(None, qm, fs),
        },
        "ssm": {
            "w_in": P(None, fs, m),
            "conv_w": P(None, None, m),
            "conv_b": P(None, m),
            "w_xdb": P(None, m, None),
            "w_dt": P(None, None, m),
            "b_dt": P(None, m),
            "a_log": P(None, m, None),
            "d_skip": P(None, m),
            "w_out": P(None, m, fs),
        },
        "attn_norm": norm(),
        "ssm_norm": norm(),
        "mlp": {"w_in": P(None, fs, fm), "w_out": P(None, fm, fs)}
        | ({"w_gate": P(None, fs, fm)} if cfg.glu else {}),
    }
    return {
        "embed": P("model" if vocab_ok else None, fs),
        "blocks": blk,
        "final_norm": {"scale": P(None)} | ({"bias": P(None)} if cfg.norm == "layernorm" else {}),
        "lm_head": P(fs, "model" if vocab_ok else None),
    }


def cache_pspecs(cfg: LMConfig, batch_axes: tuple[str, ...], model_size: int) -> HymbaCache:
    """Cache sharding, :func:`init_cache`'s tree: batch over the data axes,
    head_dim and the SSM's inner dim over "model" where they divide."""
    b = batch_axes if batch_axes else None
    inner = _inner(cfg)
    m = "model" if inner % model_size == 0 else None
    dh = "model" if cfg.head_dim % model_size == 0 else None
    kv = P(None, b, None, None, dh)
    return HymbaCache(
        kv=KVCache(k=kv, v=kv),
        ssm=SSMState(conv=P(None, b, None, m), h=P(None, b, m, None)),
    )
