"""Adaptive reuse & fusion planner (paper Sec. V, Figs. 13-14, 16).

Given the per-layer weight / input-activation / output-activation byte
sizes of a network and an on-chip buffer budget (the paper's 2 MB global
buffer), choose per layer:

  reuse  — "input" (input stays on-chip, weights stream: best when the
           activation is the smaller operand), "weight" (vice versa), or
           "tiled" (both exceed the buffer)
  fusion — "cross" (weight-reuse layers with small weights: stream partial
           activations straight into the next layer; intermediate
           activations never leave the chip), "layer" (both activations
           fit: keep them resident between layers), or "none"

and report modeled off-chip traffic, reproducing the paper's ~24.3% /
~30.5% reuse/fusion savings ablation and the Fig. 16 buffer sweep.

The port's own copy of ``repro/core/reuse_planner.py``: a pure-Python
model of the paper's accelerator, which no kernel of the port reads.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.common.types import UNetConfig


@dataclasses.dataclass(frozen=True)
class LayerSizes:
    name: str
    weight: int  # bytes
    act_in: int
    act_out: int
    macs: int = 0  # exact MAC count (used by the latency model benches)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    name: str
    reuse: str  # "input" | "weight" | "tiled"
    fusion: str  # "cross" | "layer" | "none"
    traffic_baseline: int  # bytes, no reuse/fusion (im2col-style streaming)
    traffic_optimized: int


def unet_conv_layers(cfg: UNetConfig, dtype_bytes: int = 2) -> list[LayerSizes]:
    """The 3x3-conv layer sequence of the U-Net (paper Fig. 13 indexes 0-51)."""
    out: list[LayerSizes] = []
    chans = [cfg.base_channels * m for m in cfg.channel_mult]

    def add(name, l, cin, cout, k=3):
        out.append(
            LayerSizes(
                name,
                weight=k * k * cin * cout * dtype_bytes,
                act_in=l * cin * dtype_bytes,
                act_out=l * cout * dtype_bytes,
                macs=l * cin * cout * k * k,
            )
        )

    l = cfg.latent_size**2
    add("conv_in", l, cfg.in_channels, cfg.base_channels)
    ch = cfg.base_channels
    for lvl, cout in enumerate(chans):
        for i in range(cfg.n_res_blocks):
            add(f"d{lvl}.{i}.conv1", l, ch, cout)
            add(f"d{lvl}.{i}.conv2", l, cout, cout)
            ch = cout
        if lvl != cfg.n_levels - 1:
            add(f"d{lvl}.down", l // 4, ch, ch)
            l //= 4
    add("mid.res1.conv1", l, ch, ch)
    add("mid.res1.conv2", l, ch, ch)
    add("mid.res2.conv1", l, ch, ch)
    add("mid.res2.conv2", l, ch, ch)
    ch_up = ch
    skip_ch = [cfg.base_channels]
    c2 = cfg.base_channels
    for lvl, cout in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            c2 = cout
            skip_ch.append(c2)
        if lvl != cfg.n_levels - 1:
            skip_ch.append(c2)
    for lvl in reversed(range(cfg.n_levels)):
        cout = chans[lvl]
        cur_l = (cfg.latent_size >> lvl) ** 2
        for i in range(cfg.n_res_blocks + 1):
            sc = skip_ch.pop()
            add(f"u{lvl}.{i}.conv1", cur_l, ch_up + sc, cout)
            add(f"u{lvl}.{i}.conv2", cur_l, cout, cout)
            if i == cfg.n_res_blocks and lvl != 0:
                add(f"u{lvl}.up", cur_l * 4, cout, cout)
            ch_up = cout
    add("conv_out", cfg.latent_size**2, cfg.base_channels, cfg.out_channels)
    return out


def plan_layers(
    layers: Sequence[LayerSizes], buffer_bytes: int, im2col_blowup: float = 9.0
) -> list[LayerPlan]:
    """Assign reuse/fusion per layer and model the off-chip traffic.

    Baseline model (paper's ablation baseline): im2col streaming — the
    input activation is materialized K*K-fold, and with neither operand
    resident each weight tile is re-fetched once per activation tile pass
    (and vice versa), modeled as 2x the larger operand.
    """
    plans: list[LayerPlan] = []
    n = len(layers)
    for i, lay in enumerate(layers):
        base = int(lay.act_in * im2col_blowup + 2 * max(lay.weight, lay.act_in)) + lay.act_out

        if min(lay.weight, lay.act_in) > buffer_bytes:
            reuse, traffic = "tiled", lay.weight + 2 * lay.act_in + lay.act_out
        elif lay.act_in <= lay.weight:
            reuse, traffic = "input", lay.weight + lay.act_in + lay.act_out
        else:
            reuse, traffic = "weight", lay.weight + lay.act_in + lay.act_out

        # fusion with the next layer
        fusion = "none"
        if i + 1 < n:
            nxt = layers[i + 1]
            both_acts = lay.act_out + nxt.act_out
            if reuse == "weight" and lay.weight + nxt.weight <= buffer_bytes:
                # cross-layer: stream partial activations into the next layer
                fusion = "cross"
                traffic -= lay.act_out  # intermediate never leaves chip
            elif both_acts + max(0, min(nxt.weight, buffer_bytes // 4)) <= buffer_bytes:
                fusion = "layer"
                traffic -= lay.act_out // 2  # amortized: write once, no re-read
        plans.append(LayerPlan(lay.name, reuse, fusion, base, max(traffic, 0)))
    return plans


def traffic_summary(plans: Sequence[LayerPlan]) -> dict:
    base = sum(p.traffic_baseline for p in plans)
    opt = sum(p.traffic_optimized for p in plans)
    return {
        "baseline_bytes": base,
        "optimized_bytes": opt,
        "reduction": 1 - opt / max(base, 1),
        "n_input_reuse": sum(p.reuse == "input" for p in plans),
        "n_weight_reuse": sum(p.reuse == "weight" for p in plans),
        "n_tiled": sum(p.reuse == "tiled" for p in plans),
        "n_cross_fused": sum(p.fusion == "cross" for p in plans),
        "n_layer_fused": sum(p.fusion == "layer" for p in plans),
    }


def buffer_sweep(layers: Sequence[LayerSizes], sizes_bytes: Sequence[int]) -> dict[int, int]:
    """Paper Fig. 16 (right): off-chip traffic vs global buffer size."""
    return {s: sum(p.traffic_optimized for p in plan_layers(layers, s)) for s in sizes_bytes}
