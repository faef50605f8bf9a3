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

The configuration's model module (``bench/reference/<model>.py``) lays
the trees out through :class:`_Spec`: which leaves there are, their shapes
and fan-ins.  This module draws them.
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
    """Records leaves while a model lays out its tree, then fills them.

    A model's ``unet_layout(s, cfg)`` and ``vae_layout(s, cfg)`` build
    their tree from these calls; leaves are drawn in the order they are
    recorded."""

    def __init__(self):
        self.leaves: list[tuple[Any, Any, tuple[int, ...], float, float]] = []

    def normal(self, holder, key, shape, std, mean=0.0):
        self.leaves.append((holder, key, tuple(shape), std, mean))

    def conv(self, k: int, cin: int, cout: int) -> dict:
        """A K x K conv: ``w`` [K * K, Cin, Cout] and ``b`` [Cout]."""
        d: dict = {}
        self.normal(d, "w", (k * k, cin, cout), 1.0 / math.sqrt(cin * k * k))
        self.bias(d, "b", cout)
        return d

    def norm(self, c: int) -> dict:
        """A group or layer norm's affine: ``scale`` about 1, ``bias``."""
        d: dict = {}
        self.normal(d, "scale", (c,), SCALE_STD, 1.0)
        self.bias(d, "bias", c)
        return d

    def dense(self, holder, key, fan_in: int, fan_out: int):
        self.normal(holder, key, (fan_in, fan_out), 1.0 / math.sqrt(fan_in))

    def bias(self, holder, key, n: int):
        self.normal(holder, key, (n,), BIAS_STD)


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


def make_weights(cfg: dict, seed: int, device, model) -> tuple[Params, Params]:
    """(U-Net tree, VAE tree) for configuration ``cfg`` from ``seed``, in
    the layouts of ``model`` (a model module, ``bench/reference/<model>.py``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    s = _Spec()
    unet = model.unet_layout(s, cfg)
    _materialise(s, gen, cfg["dtype"] == "bfloat16")
    s = _Spec()
    vae = model.vae_layout(s, cfg)
    _materialise(s, gen, False)
    return unet, vae


def count(tree) -> int:
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count(v) for v in tree)
    return tree.numel()
