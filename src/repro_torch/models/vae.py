"""Small convolutional VAE: pixels <-> latents.

Port of ``repro/models/vae.py``: the same tree and the same (L, C) layout.
The decoder routes every conv and the group norm through a
:class:`~repro_torch.models.backend.KernelBackend`; the encoder uses the
plain ops, as the JAX package's does (it has no ``backend`` argument).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.stream_norm.ops import group_norm
from repro_torch.kernels.uniconv.ops import uniconv_apply
from repro_torch.models.backend import resolve_backend
from repro_torch.models.unet import Params, _silu, _upsample2x, init_conv, init_gn


def init_vae(
    generator: torch.Generator, *, img_channels: int = 3, latent_channels: int = 4, base: int = 32
) -> Params:
    """Random float32 weights with the JAX tree's shapes and scales."""
    g, f = generator, "float32"
    return {
        "enc": [
            init_conv(g, 3, img_channels, base, f),
            init_conv(g, 3, base, 2 * base, f),
            init_conv(g, 3, 2 * base, 2 * base, f),
            init_conv(g, 3, 2 * base, 2 * base, f),
        ],
        "enc_gn": init_gn(g, 2 * base),
        "enc_out": init_conv(g, 1, 2 * base, 2 * latent_channels, f),
        "dec_in": init_conv(g, 1, latent_channels, 2 * base, f),
        "dec": [
            init_conv(g, 3, 2 * base, 2 * base, f),
            init_conv(g, 3, 2 * base, 2 * base, f),  # after up x2
            init_conv(g, 3, 2 * base, base, f),  # after up x2
        ],
        "dec_gn": init_gn(g, base),
        "dec_out": init_conv(g, 3, base, img_channels, f),
    }


def vae_encode(p: Params, img: torch.Tensor, hw) -> tuple[torch.Tensor, torch.Tensor]:
    """img: [B, H*W, C]. Returns (mu, logvar) at H/4 x W/4."""
    h = img
    cur = hw
    for conv, s in zip(p["enc"], (1, 2, 1, 2)):
        h = uniconv_apply(conv["w"], conv["b"], h, cur, 3, stride=s)
        if s == 2:
            cur = (cur[0] // 2, cur[1] // 2)
        h = _silu(h)
    h = group_norm(h, p["enc_gn"], 8)
    out = uniconv_apply(p["enc_out"]["w"], p["enc_out"]["b"], h, cur, 1)
    mu, logvar = torch.chunk(out, 2, dim=-1)
    return mu, logvar


def vae_decode(p: Params, z: torch.Tensor, hw, backend=None) -> torch.Tensor:
    """z: [B, (H/4)*(W/4), Cz] -> image [B, H*W, C]."""
    bk = resolve_backend(backend)
    cur = hw
    h = bk.conv(p["dec_in"]["w"], p["dec_in"]["b"], z, cur, 1)
    h = _silu(bk.conv(p["dec"][0]["w"], p["dec"][0]["b"], h, cur, 3))
    h, cur = _upsample2x(h, cur)
    h = _silu(bk.conv(p["dec"][1]["w"], p["dec"][1]["b"], h, cur, 3))
    h, cur = _upsample2x(h, cur)
    h = _silu(bk.conv(p["dec"][2]["w"], p["dec"][2]["b"], h, cur, 3))
    h = bk.group_norm(h, p["dec_gn"], 8)
    return bk.conv(p["dec_out"]["w"], p["dec_out"]["b"], h, cur, 3)
