"""StableDiff U-Net in PyTorch with block-granular partial execution for PAS.

Port of ``repro/models/unet.py``: the same parameter tree (nested dicts and
lists of tensors), the same [B, H*W, C] activation layout, and the same
partial-execution contract: ``entry_step == e > 0`` runs only the down
blocks whose skips up-steps e..end consume, and enters up-step ``e`` with
the cached main-branch feature ``entry_feat`` (the paper's sketch reuse).

Every conv, group norm and attention goes through a
:class:`~repro_torch.models.backend.KernelBackend`.  Activations are
float32; weights of a "bfloat16" config are float32 tensors holding
bf16-rounded values, which is what the JAX path computes with when it
promotes ``fp32 @ bf16`` to float32.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from repro_torch.common import trace as T
from repro_torch.common.types import UNetConfig
from repro_torch.kernels.flash_attention.ops import mha as _mha  # noqa: F401 (counterpart name)
from repro_torch.kernels.stream_norm.ops import group_norm  # noqa: F401 (counterpart name)
from repro_torch.kernels.uniconv.ops import uniconv_apply  # noqa: F401 (counterpart name)
from repro_torch.models.backend import resolve_backend

Params = dict[str, Any]


def _round_to(t: torch.Tensor, dtype: str) -> torch.Tensor:
    """float32 tensor holding the values of ``dtype`` ("float32" | "bfloat16")."""
    return t.to(torch.bfloat16).float() if dtype == "bfloat16" else t


def _normal(gen: torch.Generator, shape, std: float, dtype: str) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, device=gen.device)
    t = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * std
    return _round_to(t, dtype)


def _dense_init(gen, shape, dtype: str) -> torch.Tensor:
    return _normal(gen, shape, 1.0 / math.sqrt(shape[-2]), dtype)


def _zeros(gen, n: int) -> torch.Tensor:
    return torch.zeros((n,), device=gen.device)


def init_conv(gen, ksize: int, cin: int, cout: int, dtype: str) -> Params:
    std = 1.0 / math.sqrt(cin * ksize * ksize)
    return {"w": _normal(gen, (ksize * ksize, cin, cout), std, dtype), "b": _zeros(gen, cout)}


def init_gn(gen, c: int) -> Params:
    return {"scale": torch.ones((c,), device=gen.device), "bias": _zeros(gen, c)}


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    s = xf.mean(dim=-1, keepdim=True)
    sq = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf - s) * torch.rsqrt(torch.clamp(sq - s * s, min=0.0) + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _dense(*products) -> list[torch.Tensor]:
    """``x @ w``, plus ``b`` where given, of each ``(x, w)`` or ``(x, w, b)``,
    in one ``linear`` range (:mod:`repro_torch.common.trace`)."""
    with T.work("linear", T.dense_cost, *products):
        return [x @ w + b[0] if b else x @ w for x, w, *b in products]


# ---------------------------------------------------------------------------
# ResBlock and transformer block
# ---------------------------------------------------------------------------


def init_res(gen, cin: int, cout: int, tdim: int, dtype: str) -> Params:
    p = {
        "gn1": init_gn(gen, cin),
        "conv1": init_conv(gen, 3, cin, cout, dtype),
        "t_proj": {"w": _dense_init(gen, (tdim, cout), dtype), "b": _zeros(gen, cout)},
        "gn2": init_gn(gen, cout),
        "conv2": init_conv(gen, 3, cout, cout, dtype),
    }
    if cin != cout:
        p["skip"] = init_conv(gen, 1, cin, cout, dtype)
    return p


def apply_res(p: Params, x, temb, hw, groups: int, backend=None) -> torch.Tensor:
    bk = resolve_backend(backend)
    h = bk.group_norm(x, p["gn1"], groups, silu=True)
    h = bk.conv(p["conv1"]["w"], p["conv1"]["b"], h, hw, 3)
    h = h + _dense((_silu(temb), p["t_proj"]["w"], p["t_proj"]["b"]))[0][:, None, :]
    h = bk.group_norm(h, p["gn2"], groups, silu=True)
    h = bk.conv(p["conv2"]["w"], p["conv2"]["b"], h, hw, 3)
    if "skip" in p:
        x = bk.conv(p["skip"]["w"], p["skip"]["b"], x, hw, 1)
    return x + h


def init_tf(gen, c: int, ctx_dim: int, dtype: str) -> Params:
    def ln():
        return {"scale": torch.ones((c,), device=gen.device), "bias": _zeros(gen, c)}

    return {
        "gn": init_gn(gen, c),
        "proj_in": init_conv(gen, 1, c, c, dtype),
        "ln1": ln(),
        "self_q": _dense_init(gen, (c, c), dtype),
        "self_k": _dense_init(gen, (c, c), dtype),
        "self_v": _dense_init(gen, (c, c), dtype),
        "self_o": _dense_init(gen, (c, c), dtype),
        "ln2": ln(),
        "cross_q": _dense_init(gen, (c, c), dtype),
        "cross_k": _dense_init(gen, (ctx_dim, c), dtype),
        "cross_v": _dense_init(gen, (ctx_dim, c), dtype),
        "cross_o": _dense_init(gen, (c, c), dtype),
        "ln3": ln(),
        "ff_in": _dense_init(gen, (c, 8 * c), dtype),  # GEGLU: 2 * 4c
        "ff_out": _dense_init(gen, (4 * c, c), dtype),
        "proj_out": init_conv(gen, 1, c, c, dtype),
    }


def apply_tf(p: Params, x, ctx, hw, n_heads: int, groups: int, backend=None) -> torch.Tensor:
    bk = resolve_backend(backend)
    res0 = x
    h = bk.group_norm(x, p["gn"], groups)
    h = bk.conv(p["proj_in"]["w"], p["proj_in"]["b"], h, hw, 1)

    z = layer_norm(h, p["ln1"])
    h = h + bk.attention(
        *_dense((z, p["self_q"]), (z, p["self_k"]), (z, p["self_v"])), p["self_o"], n_heads
    )
    z = layer_norm(h, p["ln2"])
    h = h + bk.attention(
        *_dense((z, p["cross_q"]), (ctx, p["cross_k"]), (ctx, p["cross_v"])), p["cross_o"], n_heads
    )
    z = layer_norm(h, p["ln3"])
    gate, val = torch.chunk(_dense((z, p["ff_in"]))[0], 2, dim=-1)
    # paper's sigmoid GELU
    h = h + _dense((gate * torch.sigmoid(1.702 * gate) * val, p["ff_out"]))[0]

    h = bk.conv(p["proj_out"]["w"], p["proj_out"]["b"], h, hw, 1)
    return h + res0


# ---------------------------------------------------------------------------
# U-Net assembly
# ---------------------------------------------------------------------------


def _level_channels(cfg: UNetConfig) -> list[int]:
    return [cfg.base_channels * m for m in cfg.channel_mult]


def init_unet(cfg: UNetConfig, generator: torch.Generator) -> Params:
    """Random weights with the JAX tree's shapes and scales, drawn from
    ``generator`` on its device (the numbers differ from JAX's by design)."""
    gen, dtype = generator, cfg.dtype
    chans = _level_channels(cfg)
    tdim = cfg.time_dim
    params: Params = {
        "time_mlp": {
            "w1": _dense_init(gen, (cfg.base_channels, tdim), dtype),
            "b1": _zeros(gen, tdim),
            "w2": _dense_init(gen, (tdim, tdim), dtype),
            "b2": _zeros(gen, tdim),
        },
        "conv_in": init_conv(gen, 3, cfg.in_channels, cfg.base_channels, dtype),
        "down": [],
        "mid": {},
        "up": [],
        "gn_out": init_gn(gen, cfg.base_channels),
        "conv_out": init_conv(gen, 3, cfg.base_channels, cfg.out_channels, dtype),
    }

    ch = cfg.base_channels
    for lvl, cout in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            blk = {"res": init_res(gen, ch, cout, tdim, dtype)}
            if lvl in cfg.attn_levels:
                blk["tf"] = [init_tf(gen, cout, cfg.ctx_dim, dtype) for _ in range(cfg.tf_depth)]
            params["down"].append(blk)
            ch = cout
        if lvl != cfg.n_levels - 1:
            params["down"].append({"downsample": init_conv(gen, 3, ch, ch, dtype)})

    params["mid"] = {
        "res1": init_res(gen, ch, ch, tdim, dtype),
        "tf": [init_tf(gen, ch, cfg.ctx_dim, dtype) for _ in range(cfg.tf_depth)],
        "res2": init_res(gen, ch, ch, tdim, dtype),
    }

    # up path: skip channels are consumed in reverse production order
    skip_ch = [cfg.base_channels]
    for lvl, cout in enumerate(chans):
        skip_ch += [cout] * cfg.n_res_blocks
        if lvl != cfg.n_levels - 1:
            skip_ch.append(cout)
    ch_up = ch
    for lvl in reversed(range(cfg.n_levels)):
        cout = chans[lvl]
        for i in range(cfg.n_res_blocks + 1):
            blk = {"res": init_res(gen, ch_up + skip_ch.pop(), cout, tdim, dtype)}
            if lvl in cfg.attn_levels:
                blk["tf"] = [init_tf(gen, cout, cfg.ctx_dim, dtype) for _ in range(cfg.tf_depth)]
            if i == cfg.n_res_blocks and lvl != 0:
                blk["upsample"] = init_conv(gen, 3, cout, cout, dtype)
            params["up"].append(blk)
            ch_up = cout
    return params


class _Shapes:
    """Stands in for the generator of :func:`init_unet`, which then builds
    the tree on the meta device: shapes, no storage and no draws."""

    device = torch.device("meta")


def param_dtypes(cfg: UNetConfig) -> Params:
    """The JAX package's dtype of every leaf, in a tree of the parameter
    tree's shape: the group norm and layer norm scales and biases are
    float32; every conv, dense and attention weight and its bias is
    ``cfg.dtype``.  The port holds every leaf as float32, so its training
    step rounds a bfloat16 leaf's gradient and updated value to bfloat16,
    as the JAX package's gradient and cast-back do."""
    low = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def walk(tree, norm: bool = False):
        if isinstance(tree, dict):
            return {k: walk(v, set(tree) == {"scale", "bias"}) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return torch.float32 if norm else low

    return walk(init_unet(cfg, _Shapes()))


def n_up_steps(cfg: UNetConfig) -> int:
    return cfg.n_levels * (cfg.n_res_blocks + 1)


def _down_plan(cfg: UNetConfig) -> list[tuple[int, bool, bool]]:
    """(level, has_attn, is_downsample) per down entry (after conv_in)."""
    plan = []
    for lvl in range(cfg.n_levels):
        for _ in range(cfg.n_res_blocks):
            plan.append((lvl, lvl in cfg.attn_levels, False))
        if lvl != cfg.n_levels - 1:
            plan.append((lvl, False, True))
    return plan


def _up_plan(cfg: UNetConfig) -> list[tuple[int, bool, bool]]:
    plan = []
    for lvl in reversed(range(cfg.n_levels)):
        for i in range(cfg.n_res_blocks + 1):
            plan.append((lvl, lvl in cfg.attn_levels, i == cfg.n_res_blocks and lvl != 0))
    return plan


def _upsample2x(x: torch.Tensor, hw) -> tuple[torch.Tensor, tuple[int, int]]:
    h, w = hw
    x2 = x.reshape(x.shape[0], h, w, x.shape[-1])
    x2 = x2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # nearest interpolation
    return x2.reshape(x.shape[0], 4 * h * w, x.shape[-1]), (2 * h, 2 * w)


def unet_apply(
    cfg: UNetConfig,
    params: Params,
    x: torch.Tensor,  # [B, L0, Cin] latent in (L, C) layout
    t: torch.Tensor,  # [B] timesteps
    ctx: torch.Tensor,  # [B, ctx_len, ctx_dim]
    *,
    entry_step: int = 0,  # first up-step to execute (0 = full run)
    entry_feat: torch.Tensor | None = None,  # cached main-branch feature
    capture_steps: Sequence[int] = (),
    backend=None,  # KernelBackend instance or name; None = "eager"
) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
    """Full or partial U-Net forward -> (eps, {captured step -> feature})."""
    bk = resolve_backend(backend)
    size = cfg.latent_size
    hw = (size, size)
    groups = cfg.groups

    temb = timestep_embedding(t, cfg.base_channels).to(x.dtype)
    tm = params["time_mlp"]
    temb = _dense((temb, tm["w1"], tm["b1"]))[0]
    temb = _dense((_silu(temb), tm["w2"], tm["b2"]))[0]

    up_plan = _up_plan(cfg)
    n_up = len(up_plan)
    n_skips_needed = n_up - entry_step  # up-steps consume skips in reverse

    h = bk.conv(params["conv_in"]["w"], params["conv_in"]["b"], x, hw, 3)
    skips = [h]
    hws = [hw]
    for entry, (lvl, has_attn, is_down) in zip(params["down"], _down_plan(cfg)):
        if len(skips) >= n_skips_needed and entry_step > 0:
            break
        if is_down:
            h = bk.conv(entry["downsample"]["w"], entry["downsample"]["b"], h, hw, 3, stride=2)
            hw = (hw[0] // 2, hw[1] // 2)
        else:
            h = apply_res(entry["res"], h, temb, hw, groups, backend=bk)
            if has_attn:
                for tfp in entry["tf"]:
                    h = apply_tf(tfp, h, ctx, hw, cfg.n_heads, groups, backend=bk)
        skips.append(h)
        hws.append(hw)

    captured: dict[int, torch.Tensor] = {}
    if entry_step == 0:
        m = params["mid"]
        h = apply_res(m["res1"], h, temb, hw, groups, backend=bk)
        for tfp in m["tf"]:
            h = apply_tf(tfp, h, ctx, hw, cfg.n_heads, groups, backend=bk)
        h = apply_res(m["res2"], h, temb, hw, groups, backend=bk)
    else:
        if entry_feat is None:
            raise ValueError("a partial run needs the cached entry feature")
        h = entry_feat
        hw = hws[n_skips_needed - 1]  # resolution of the entry up-step

    for step in range(entry_step, n_up):
        if step in capture_steps:
            captured[step] = h
        entry = params["up"][step]
        skip = skips.pop()
        hw = hws.pop()
        h = torch.cat([h, skip], dim=-1)
        h = apply_res(entry["res"], h, temb, hw, groups, backend=bk)
        lvl, has_attn, up_after = up_plan[step]
        if has_attn:
            for tfp in entry["tf"]:
                h = apply_tf(tfp, h, ctx, hw, cfg.n_heads, groups, backend=bk)
        if up_after:
            h, hw = _upsample2x(h, hw)
            h = bk.conv(entry["upsample"]["w"], entry["upsample"]["b"], h, hw, 3)

    h = bk.group_norm(h, params["gn_out"], groups, silu=True)
    eps = bk.conv(params["conv_out"]["w"], params["conv_out"]["b"], h, hw, 3)
    return eps, captured
