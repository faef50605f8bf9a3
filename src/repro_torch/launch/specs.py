"""Meta-tensor stand-ins and partition specs for every (arch x shape) cell.

The port's copy of ``repro/launch/specs.py``.  ``input_specs`` returns
everything ``dryrun.py`` needs to cost a cell without allocating a byte on
any device: the args as trees of ``meta`` tensors (the reference's
``ShapeDtypeStruct`` trees, same shapes and dtypes), in / out specs as
trees of :class:`~repro_torch.common.sharding.P`, the donated args, and
the step function, built by the same ``launch/steps.py`` builders the
trainer and the server run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.sharding import P, Mesh, batch_axes, dp_size, tp_size
from repro_torch.common.types import LMConfig, ShapeCell
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import AdamWConfig, init_adamw


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class CellSpec:
    name: str
    step_fn: Callable
    args: tuple  # trees of meta tensors
    in_shardings: tuple  # trees of P, one per arg
    out_shardings: Any  # a tree of P over the step's outputs
    donate_argnums: tuple = ()


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """Performance knobs beyond the paper.

    Defaults are the paper-faithful baseline; ``optimized()`` is the
    reference's hill-climbed configuration.
    """

    chunked_ce: int = 0  # S-chunk size for the train loss; 0 = plain CE
    infer_fsdp: str = "on"  # "on" | "off" | "auto": ZeRO-3 weights at inference
    decode_seq_shard: bool = False  # shard KV-cache sequence over the model axis
    #: "auto": max per-device weight bytes, half an H100's memory (the
    #: reference's 8 GiB is half a v5e's 16 GiB)
    infer_fsdp_budget: int = HBM_BYTES // 2
    #: prefill: gather only k / v.  Refuted in the reference (GSPMD then
    #: reshards the wider q instead) and off in optimized(); the port runs
    #: no SPMD program, so it changes no layout here
    gqa_prefill_kv_gather: bool = False

    @staticmethod
    def optimized() -> "PerfConfig":
        return PerfConfig(chunked_ce=512, infer_fsdp="auto", decode_seq_shard=True)


def _frontend_dim(cfg: LMConfig) -> int | None:
    return cfg.d_model if cfg.frontend_stub else None


def _logits_spec(cfg: LMConfig, batch_spec_axes, ms: int) -> P:
    vocab = "model" if cfg.vocab_size % ms == 0 else None
    if cfg.n_codebooks > 1:
        return P(batch_spec_axes, None, vocab)
    return P(batch_spec_axes, vocab)


def params_struct(adapter: S.ArchAdapter):
    """The adapter's parameter tree as ``meta`` tensors (no device memory)."""
    return adapter.init(torch.Generator().manual_seed(0), "meta")


def input_specs(
    cfg: LMConfig,
    cell: ShapeCell,
    mesh: Mesh,
    opt_cfg: AdamWConfig | None = None,
    perf: PerfConfig | None = None,
) -> CellSpec:
    perf = perf or PerfConfig()
    adapter = S.get_adapter(cfg)
    ms = tp_size(mesh)
    ba = batch_axes(mesh)
    b, s = cell.global_batch, cell.seq_len
    dp = dp_size(mesh)
    # long-context single-sequence cells can't shard the batch
    batch_spec_axes = ba if b % dp == 0 and b >= dp else None

    # inference weight layout: drop the ZeRO-3 axis when the TP-sharded
    # weights fit the budget (kills per-layer weight all-gathers)
    fsdp: str | None = "data"
    if cell.kind != "train":
        if perf.infer_fsdp == "off":
            fsdp = None
        elif perf.infer_fsdp == "auto":
            per_dev = 2 * cfg.param_count() // ms  # bf16 TP-sharded
            fsdp = None if per_dev <= perf.infer_fsdp_budget else "data"

    pspecs = adapter.pspecs(ms, fsdp)
    p_struct = params_struct(adapter)
    dt = torch_dtype(cfg.dtype)
    name = f"{cfg.name}:{cell.name}"

    def inputs_of(shape_tokens):
        if adapter.takes_embeddings:
            return _meta(shape_tokens + (cfg.d_model,), dt), P(batch_spec_axes, None, None)
        return _meta(shape_tokens, torch.int32), P(batch_spec_axes, None)

    if cell.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        opt_struct = init_adamw(p_struct)
        inputs, in_spec = inputs_of((b, s))
        if cfg.n_codebooks > 1:
            labels = _meta((b, s, cfg.n_codebooks), torch.int32)
            lab_spec = P(batch_spec_axes, None, None)
        else:
            labels = _meta((b, s), torch.int32)
            lab_spec = P(batch_spec_axes, None)
        p_shard = pspecs
        opt_shard = S.opt_pspecs(pspecs)
        return CellSpec(
            name=name,
            step_fn=S.make_train_step(adapter, opt_cfg, chunked_ce=perf.chunked_ce),
            args=(p_struct, opt_struct, {"inputs": inputs, "labels": labels}),
            in_shardings=(p_shard, opt_shard, {"inputs": in_spec, "labels": lab_spec}),
            out_shardings=(p_shard, opt_shard, P()),
            donate_argnums=(0, 1),
        )

    if cell.kind == "prefill":
        inputs, in_spec = inputs_of((b, s))
        return CellSpec(
            name=name,
            step_fn=S.make_prefill_step(adapter),
            args=(p_struct, inputs),
            in_shardings=(pspecs, in_spec),
            out_shardings=_logits_spec(cfg, batch_spec_axes, ms),
        )

    # decode: one new token against a seq_len-deep cache / recurrent state.
    # Baseline shards the cache sequence only for unbatchable long-context
    # cells; the optimized layout always seq-shards global-layer caches over
    # the model axis (flash-decoding style).
    seq_axis = "data" if batch_spec_axes is None else None
    if perf.decode_seq_shard and seq_axis is None and s % ms == 0:
        seq_axis = "model"
    cache_struct = adapter.init_cache(b, s, "meta")
    cache_shard = adapter.cache_pspecs(batch_spec_axes or (), seq_axis, ms)
    if adapter.takes_embeddings:
        token = _meta((b, cfg.d_model), dt)
        tok_spec = P(batch_spec_axes, None)
    else:
        token = _meta((b,), torch.int32)
        tok_spec = P(batch_spec_axes)
    pos = _meta((), torch.int32)
    return CellSpec(
        name=name,
        step_fn=S.make_decode_step(adapter),
        args=(p_struct, cache_struct, token, pos),
        in_shardings=(pspecs, cache_shard, tok_spec, P()),
        out_shardings=(_logits_spec(cfg, batch_spec_axes, ms), cache_shard),
        donate_argnums=(1,),
    )
