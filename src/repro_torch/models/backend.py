"""Kernel-backend dispatch for the served U-Net/VAE hot path.

One :class:`KernelBackend` bundles the three primitives the paper's Sec. IV
kernels replace (Uni-conv, group norm with the fused SiLU, softmax
attention), so model code routes every hot call through one object chosen
per engine:

* ``"eager"``: the plain PyTorch versions, op for op the JAX package's
  ``"xla"`` backend;
* ``"cuda"``: the hand-written Hopper kernels of
  :data:`repro_torch.kernels.KERNEL_REGISTRY`, built from the registry as the
  JAX package builds its ``"pallas"`` backend.  On a CUDA tensor a
  wrapper launches its kernel or raises; it takes the plain version only
  for a tensor on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.kernels import KERNEL_REGISTRY
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.stream_norm.ops import stream_group_norm_plain
from repro_torch.kernels.uniconv.ops import uniconv_apply

#: the selectable kernel backends
BACKENDS = ("eager", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """The three hot-path primitives, uniformly shaped across backends.

    * ``conv(w, b, x, hw, ksize, stride=1)``: K*K conv, ``x`` is [B, L, Cin];
    * ``group_norm(x, p, groups, *, eps=1e-5, silu=False)`` over
      ``p = {"scale", "bias"}``;
    * ``attention(q, k, v, o_proj, n_heads)``: multi-head softmax attention
      over projected [B, L, C] tensors, including the output projection.
    """

    name: str
    conv: Callable[..., Any]
    group_norm: Callable[..., Any]
    attention: Callable[..., Any]


def _split_heads(x, n_heads: int):
    b, l, c = x.shape
    return x.reshape(b, l, n_heads, c // n_heads).transpose(1, 2).contiguous()


def _eager_group_norm(x, p, groups, *, eps=1e-5, silu=False):
    return stream_group_norm_plain(x, p["scale"], p["bias"], groups=groups, eps=eps, silu=silu)


def _make_cuda() -> KernelBackend:
    uniconv = KERNEL_REGISTRY["uniconv"][0]
    stream_group_norm = KERNEL_REGISTRY["stream_group_norm"][0]
    flash_attention = KERNEL_REGISTRY["flash_attention"][0]

    def conv(w, b, x, hw, ksize, stride=1):
        return uniconv(x, w, b, hw, ksize, stride)

    def group_norm(x, p, groups, *, eps=1e-5, silu=False):
        return stream_group_norm(x, p["scale"], p["bias"], groups=groups, eps=eps, silu=silu)

    def attention(q, k, v, o_proj, n_heads):
        # the kernel applies the 1/sqrt(dh) scale itself, so q goes in unscaled
        bsz, lq, c = q.shape
        out = flash_attention(
            _split_heads(q, n_heads), _split_heads(k, n_heads), _split_heads(v, n_heads),
            causal=False,
        )
        return out.transpose(1, 2).reshape(bsz, lq, c) @ o_proj

    return KernelBackend("cuda", conv, group_norm, attention)


EAGER = KernelBackend("eager", uniconv_apply, _eager_group_norm, mha)
CUDA = _make_cuda()


def resolve_backend(backend: Any = None) -> KernelBackend:
    """Name (``"eager"`` | ``"cuda"`` | None = eager) or instance -> instance."""
    if isinstance(backend, KernelBackend):
        return backend
    name = backend or "eager"
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; expected one of {list(BACKENDS)}")
    return EAGER if name == "eager" else CUDA
