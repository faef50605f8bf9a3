"""Arch adapters: one (init, forward, decode, init_cache, pspecs) surface
over the LM families, plus the train / prefill / decode step builders the
trainer, the server and the dry run share.  The port's copy of
``repro/launch/steps.py``: the transformer family (dense, moe, audio,
vlm), xlstm (``ssm``) and hymba (``hybrid``).  The steps run off-mesh;
``pspecs``, ``cache_pspecs`` and :func:`opt_pspecs` give the reference's
mesh layout, which ``launch/dryrun.py`` costs.

A train step differentiates with autograd and updates with the port's
AdamW (:func:`repro_torch.optim.adamw_update`); the loss is the mean token
NLL in float32 plus ``1e-2`` times the MoE aux loss, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.sharding import P
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.common.types import LMConfig
from repro_torch.models import hymba as HY
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.optim import AdamWConfig, AdamWState, adamw_update

Params = Any

#: the recurrent families: ``ssm`` is served by ``models/xlstm.py``, ``hybrid``
#: by ``models/hymba.py``; the other families by ``models/transformer.py``
RECURRENT_FAMILIES = ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ArchAdapter:
    cfg: LMConfig
    init: Callable[..., Params]  # (generator, device)
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]  # (params, inputs, remat)
    decode: Callable[..., tuple[torch.Tensor, Any]]  # (params, cache, token, pos)
    init_cache: Callable[..., Any]  # (batch, max_len, device)
    pspecs: Callable[..., Any]  # (model_size, fsdp_axis)
    cache_pspecs: Callable[..., Any]  # (batch_axes, seq_axis, model_size)
    # backbone/head split for the chunked train loss
    forward_hidden: Callable[..., tuple[torch.Tensor, torch.Tensor]]  # (params, inputs, remat)
    head_logits: Callable[..., torch.Tensor]  # (params, h_chunk)

    @property
    def takes_embeddings(self) -> bool:
        return self.cfg.frontend_stub is not None


def get_adapter(cfg: LMConfig) -> ArchAdapter:
    if cfg.family == "ssm":
        return ArchAdapter(
            cfg=cfg,
            init=lambda gen, device: X.init_xlstm(gen, cfg, device),
            forward=lambda p, x, remat=False: X.xlstm_forward(cfg, p, x, remat=remat),
            decode=lambda p, c, tok, pos: X.xlstm_decode(cfg, p, c, tok, pos),
            init_cache=lambda batch, max_len, device: X.init_state(cfg, batch, device),
            pspecs=lambda ms, fsdp="data": X.xlstm_pspecs(cfg, ms, fsdp),
            cache_pspecs=lambda ba, sa, ms: X.state_pspecs(cfg, ba, ms),
            forward_hidden=lambda p, x, remat=False: X.xlstm_forward_hidden(
                cfg, p, x, remat=remat),
            head_logits=lambda p, h: X.xlstm_head_logits(cfg, p, h),
        )
    if cfg.family == "hybrid":
        return ArchAdapter(
            cfg=cfg,
            init=lambda gen, device: HY.init_hymba(gen, cfg, device),
            forward=lambda p, x, remat=False: HY.hymba_forward(cfg, p, x, remat=remat),
            decode=lambda p, c, tok, pos: HY.hymba_decode(cfg, p, c, tok, pos),
            init_cache=lambda batch, max_len, device: HY.init_cache(cfg, batch, max_len, device),
            pspecs=lambda ms, fsdp="data": HY.hymba_pspecs(cfg, ms, fsdp),
            cache_pspecs=lambda ba, sa, ms: HY.cache_pspecs(cfg, ba, ms),
            forward_hidden=lambda p, x, remat=False: HY.hymba_forward_hidden(
                cfg, p, x, remat=remat),
            head_logits=lambda p, h: HY.hymba_head_logits(cfg, p, h),
        )
    return ArchAdapter(
        cfg=cfg,
        init=lambda gen, device: T.init_lm(gen, cfg, device),
        forward=lambda p, x, remat=False: T.lm_forward(cfg, p, x, remat=remat),
        decode=lambda p, c, tok, pos: T.lm_decode(cfg, p, c, tok, pos),
        init_cache=lambda batch, max_len, device: T.init_cache(cfg, batch, max_len, device),
        pspecs=lambda ms, fsdp="data": T.lm_pspecs(cfg, ms, fsdp),
        cache_pspecs=lambda ba, sa, ms: T.cache_pspecs(cfg, ba, sa, ms),
        forward_hidden=lambda p, x, remat=False: T.lm_forward_hidden(cfg, p, x, remat=remat),
        head_logits=lambda p, h: T.lm_head_logits(cfg, p, h),
    )


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed ``logsumexp - gold`` in float32.  Labels need one dimension
    fewer than the logits, as ``jnp.take_along_axis`` demands (a
    multi-codebook model's [B, S, N, V] logits against [B, S] labels raise
    the reference's ValueError)."""
    if labels.ndim + 1 != logits.ndim:
        raise ValueError("indices and arr must have the same number of dimensions; "
                         f"{labels.ndim + 1} vs. {logits.ndim}")
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., V] any float dtype; labels [...] int. Mean NLL in fp32."""
    return _nll_sum(logits, labels) / labels.numel()


def _chunked(fn, xs: torch.Tensor, labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean of ``fn(x_chunk, label_chunk)`` summed over S-chunks, each chunk
    recomputed in the backward where a gradient is wanted."""
    recompute = torch.is_grad_enabled() and xs.requires_grad
    total = torch.zeros((), dtype=torch.float32, device=xs.device)
    for c0 in range(0, labels.shape[1], chunk):
        args = (xs[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
        total = total + (checkpoint(fn, *args, use_reentrant=False) if recompute else fn(*args))
    return total / labels.numel()


def cross_entropy_chunked(logits: torch.Tensor, labels: torch.Tensor,
                          chunk: int = 256) -> torch.Tensor:
    """Sequence-chunked NLL: the math of :func:`cross_entropy`, with the
    float32 ``logsumexp`` intermediates of one S-chunk at a time."""
    s = labels.shape[1]
    if s % chunk or s <= chunk:
        return cross_entropy(logits, labels)
    return _chunked(_nll_sum, logits, labels, chunk)


def cross_entropy_from_hidden(
    adapter: ArchAdapter, params: Params, h: torch.Tensor, labels: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Chunked loss head: project S-chunks of the hidden states to logits
    one at a time, so the [B, S, V] logits never exist whole; the math of
    plain :func:`cross_entropy`."""
    s = h.shape[1]
    if s % chunk or s <= chunk:
        return cross_entropy(adapter.head_logits(params, h), labels)
    return _chunked(lambda hc, lc: _nll_sum(adapter.head_logits(params, hc), lc), h, labels,
                    chunk)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def make_train_step(
    adapter: ArchAdapter,
    opt_cfg: AdamWConfig,
    *,
    remat: bool = True,
    chunked_ce: int = 0,  # 0 = plain CE; >0 = S-chunk size
):
    """``step(params, opt, batch) -> (params, opt, loss)``; ``batch`` holds
    ``inputs`` (token ids or stub embeddings) and ``labels``."""

    def loss_fn(p, batch):
        inputs, labels = batch["inputs"], batch["labels"]
        if chunked_ce:
            h, aux = adapter.forward_hidden(p, inputs, remat=remat)
            loss = cross_entropy_from_hidden(adapter, p, h, labels, chunked_ce)
        else:
            logits, aux = adapter.forward(p, inputs, remat=remat)
            loss = cross_entropy(logits, labels)
        return loss + 1e-2 * aux

    def train_step(params: Params, opt: AdamWState, batch: dict):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, live), batch)
            # a leaf the loss never reads (the embedding table of a stub
            # frontend) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, live, materialize_grads=True)
        params, opt = adamw_update(opt_cfg, params, tree_unflatten(params, list(grads)), opt)
        return params, opt, loss.detach()

    return train_step


def make_prefill_step(adapter: ArchAdapter):
    @torch.no_grad()
    def prefill_step(params: Params, inputs: torch.Tensor) -> torch.Tensor:
        logits, _ = adapter.forward(params, inputs)
        return logits[:, -1]

    return prefill_step


def make_decode_step(adapter: ArchAdapter):
    @torch.no_grad()
    def serve_step(params: Params, cache: Any, token: torch.Tensor, pos: int):
        return adapter.decode(params, cache, token, pos)

    return serve_step


# ---------------------------------------------------------------------------
# Optimizer sharding mirrors the params
# ---------------------------------------------------------------------------


def opt_pspecs(param_specs: Any) -> AdamWState:
    return AdamWState(
        step=P(),
        m=param_specs,
        v=param_specs,
    )
