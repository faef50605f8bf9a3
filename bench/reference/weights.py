"""Seeded random weights in the served tree layout, made in bulk on a device.

The tree is the one the served U-Net and VAE read: nested dicts and lists
of float32 tensors, a K x K conv weight [K * K, Cin, Cout] with its bias,
a dense weight [fan_in, fan_out], group and layer norms as ``scale`` /
``bias``.  Every leaf is a slice of one normal draw from a
``torch.Generator`` on the device: weights scaled by 1 / sqrt(fan_in),
biases and norm shifts by ``BIAS_STD``, norm scales 1 + N(0, ``SCALE_STD``),
so that a bias or a norm's affine that a kernel drops or misplaces shows
in the output.  A "bfloat16" model holds bf16-rounded values in float32,
as it is served.  The same seed and device give the same tree,
so the reference rebuilds its own copy rather than reading the served one.
"""
from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]

#: standard deviation of every bias and norm shift, and of a norm scale about 1
BIAS_STD = 0.05
SCALE_STD = 0.1


class _Spec:
    """Records leaves while the tree is laid out, then fills them."""

    def __init__(self):
        self.leaves: list[tuple[Any, Any, tuple[int, ...], float, float]] = []

    def normal(self, holder, key, shape, std, mean=0.0):
        self.leaves.append((holder, key, tuple(shape), std, mean))


def _conv(s: _Spec, d: dict, key: str, k: int, cin: int, cout: int):
    d[key] = _new_conv(s, k, cin, cout)


def _new_conv(s: _Spec, k: int, cin: int, cout: int) -> dict:
    d: dict = {}
    s.normal(d, "w", (k * k, cin, cout), 1.0 / math.sqrt(cin * k * k))
    s.normal(d, "b", (cout,), BIAS_STD)
    return d


def _norm(s: _Spec, d: dict, key: str, c: int):
    d[key] = {}
    s.normal(d[key], "scale", (c,), SCALE_STD, 1.0)
    s.normal(d[key], "bias", (c,), BIAS_STD)


def _dense(s: _Spec, d: dict, key: str, fan_in: int, fan_out: int):
    s.normal(d, key, (fan_in, fan_out), 1.0 / math.sqrt(fan_in))


def _res(s, cin, cout, tdim) -> dict:
    d: dict = {}
    _norm(s, d, "gn1", cin)
    _conv(s, d, "conv1", 3, cin, cout)
    d["t_proj"] = {}
    _dense(s, d["t_proj"], "w", tdim, cout)
    s.normal(d["t_proj"], "b", (cout,), BIAS_STD)
    _norm(s, d, "gn2", cout)
    _conv(s, d, "conv2", 3, cout, cout)
    if cin != cout:
        _conv(s, d, "skip", 1, cin, cout)
    return d


def _tf(s, c, ctx_dim) -> dict:
    d: dict = {}
    _norm(s, d, "gn", c)
    _conv(s, d, "proj_in", 1, c, c)
    _norm(s, d, "ln1", c)
    for k in ("self_q", "self_k", "self_v", "self_o"):
        _dense(s, d, k, c, c)
    _norm(s, d, "ln2", c)
    _dense(s, d, "cross_q", c, c)
    _dense(s, d, "cross_k", ctx_dim, c)
    _dense(s, d, "cross_v", ctx_dim, c)
    _dense(s, d, "cross_o", c, c)
    _norm(s, d, "ln3", c)
    _dense(s, d, "ff_in", c, 8 * c)  # GEGLU: gate and value, 4c each
    _dense(s, d, "ff_out", 4 * c, c)
    _conv(s, d, "proj_out", 1, c, c)
    return d


def _unet_layout(s: _Spec, cfg: dict) -> Params:
    base, tdim = cfg["base_channels"], cfg["time_dim"]
    chans = [base * m for m in cfg["channel_mult"]]
    n_levels, n_res = len(chans), cfg["n_res_blocks"]
    p: Params = {"time_mlp": {}, "down": [], "up": []}
    _dense(s, p["time_mlp"], "w1", base, tdim)
    s.normal(p["time_mlp"], "b1", (tdim,), BIAS_STD)
    _dense(s, p["time_mlp"], "w2", tdim, tdim)
    s.normal(p["time_mlp"], "b2", (tdim,), BIAS_STD)
    _conv(s, p, "conv_in", 3, cfg["in_channels"], base)
    tfs = lambda c: [_tf(s, c, cfg["ctx_dim"]) for _ in range(cfg["tf_depth"])]  # noqa: E731
    ch = base
    for lvl, cout in enumerate(chans):
        for _ in range(n_res):
            blk = {"res": _res(s, ch, cout, tdim)}
            if lvl in cfg["attn_levels"]:
                blk["tf"] = tfs(cout)
            p["down"].append(blk)
            ch = cout
        if lvl != n_levels - 1:
            blk = {}
            _conv(s, blk, "downsample", 3, ch, ch)
            p["down"].append(blk)
    p["mid"] = {"res1": _res(s, ch, ch, tdim), "tf": tfs(ch), "res2": _res(s, ch, ch, tdim)}
    skip_ch = [base]
    for lvl, cout in enumerate(chans):
        skip_ch += [cout] * n_res + ([cout] if lvl != n_levels - 1 else [])
    for lvl in reversed(range(n_levels)):
        cout = chans[lvl]
        for i in range(n_res + 1):
            blk = {"res": _res(s, ch + skip_ch.pop(), cout, tdim)}
            if lvl in cfg["attn_levels"]:
                blk["tf"] = tfs(cout)
            if i == n_res and lvl != 0:
                _conv(s, blk, "upsample", 3, cout, cout)
            p["up"].append(blk)
            ch = cout
    _norm(s, p, "gn_out", base)
    _conv(s, p, "conv_out", 3, base, cfg["out_channels"])
    return p


def _vae_layout(s: _Spec, latent_channels: int, img_channels: int = 3, base: int = 32) -> Params:
    p: Params = {"enc": [_new_conv(s, 3, cin, cout) for cin, cout in (
        (img_channels, base), (base, 2 * base), (2 * base, 2 * base), (2 * base, 2 * base))]}
    _norm(s, p, "enc_gn", 2 * base)
    _conv(s, p, "enc_out", 1, 2 * base, 2 * latent_channels)
    _conv(s, p, "dec_in", 1, latent_channels, 2 * base)
    p["dec"] = [_new_conv(s, 3, cin, cout) for cin, cout in (
        (2 * base, 2 * base), (2 * base, 2 * base), (2 * base, base))]
    _norm(s, p, "dec_gn", base)
    _conv(s, p, "dec_out", 3, base, img_channels)
    return p


def _materialise(s: _Spec, gen: torch.Generator, round_bf16: bool) -> None:
    n = sum(math.prod(shape) for _, _, shape, _, _ in s.leaves)
    flat = torch.randn((n,), generator=gen, device=gen.device, dtype=torch.float32)
    at = 0
    for holder, key, shape, std, mean in s.leaves:
        size = math.prod(shape)
        holder[key] = flat[at:at + size].view(shape).mul_(std).add_(mean)
        at += size
    if round_bf16:
        flat.copy_(flat.to(torch.bfloat16))


def make_weights(cfg: dict, seed: int, device) -> tuple[Params, Params]:
    """(U-Net tree, VAE tree) for configuration ``cfg`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    s = _Spec()
    unet = _unet_layout(s, cfg)
    _materialise(s, gen, cfg["dtype"] == "bfloat16")
    s = _Spec()
    vae = _vae_layout(s, cfg["in_channels"])
    _materialise(s, gen, False)
    return unet, vae


def count(tree) -> int:
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count(v) for v in tree)
    return tree.numel()
