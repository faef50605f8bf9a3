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

While a ``torch.profiler`` collects, each call opens its work
ranges (:mod:`repro_torch.common.trace`): ``uniconv``, ``stream_group_norm``,
``attention_core`` around the attention's core and ``linear`` around its
out-projection.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.common import trace as T
from repro_torch.kernels import KERNEL_REGISTRY
from repro_torch.kernels.flash_attention.ops import mha_core
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

    ``conv`` and ``attention`` are held as :func:`~repro_torch.common.trace.backend_call`
    wrappers of the functions given, so that under a backend built over
    another's (a harness that times each call) the inner call's yielding
    ranges stay shut.
    """

    name: str
    conv: Callable[..., Any]
    group_norm: Callable[..., Any]
    attention: Callable[..., Any]

    def __post_init__(self):
        for field in ("conv", "attention"):
            object.__setattr__(self, field, T.backend_call(getattr(self, field)))


def _split_heads(x, n_heads: int):
    b, l, c = x.shape
    return x.reshape(b, l, n_heads, c // n_heads).transpose(1, 2).contiguous()


def _project(out, o_proj):
    """An attention call's output projection, in its ``linear`` range."""
    with T.work("linear", T.dense_cost, (out, o_proj), yields=True):
        return out @ o_proj


def _eager_conv(w, b, x, hw, ksize, stride=1):
    with T.work("uniconv", T.conv_cost, x.shape, w.shape, hw, ksize, stride, yields=True):
        return uniconv_apply(w, b, x, hw, ksize, stride)


def _eager_group_norm(x, p, groups, *, eps=1e-5, silu=False):
    with T.work("stream_group_norm", T.group_norm_cost, x, p):
        return stream_group_norm_plain(x, p["scale"], p["bias"], groups=groups, eps=eps, silu=silu)


def _eager_attention(q, k, v, o_proj, n_heads):
    with T.work("attention_core", T.attention_core_cost, q.shape, k.shape):
        out = mha_core(q, k, v, n_heads)
    return _project(out, o_proj)


def _make_cuda() -> KernelBackend:
    uniconv = KERNEL_REGISTRY["uniconv"][0]
    stream_group_norm = KERNEL_REGISTRY["stream_group_norm"][0]
    flash_attention = KERNEL_REGISTRY["flash_attention"][0]

    def conv(w, b, x, hw, ksize, stride=1):
        with T.work("uniconv", T.conv_cost, x.shape, w.shape, hw, ksize, stride, yields=True):
            return uniconv(x, w, b, hw, ksize, stride)

    def group_norm(x, p, groups, *, eps=1e-5, silu=False):
        with T.work("stream_group_norm", T.group_norm_cost, x, p):
            return stream_group_norm(x, p["scale"], p["bias"], groups=groups, eps=eps, silu=silu)

    def attention(q, k, v, o_proj, n_heads):
        # the kernel applies the 1/sqrt(dh) scale itself, so q goes in unscaled
        bsz, lq, c = q.shape
        heads = [_split_heads(t, n_heads) for t in (q, k, v)]
        # the core range holds the kernel alone, so a range around the whole
        # call keeps its first kernels (the head splits) and, the projection's
        # range yielding to it, its last
        with T.work("attention_core", T.attention_core_cost, q.shape, k.shape):
            out = flash_attention(*heads, causal=False)
        del heads  # freed before the projection, as the call's temporaries
        return _project(out.transpose(1, 2).reshape(bsz, lq, c), o_proj)

    return KernelBackend("cuda", conv, group_norm, attention)


EAGER = KernelBackend("eager", _eager_conv, _eager_group_norm, _eager_attention)
CUDA = _make_cuda()


def resolve_backend(backend: Any = None) -> KernelBackend:
    """Name (``"eager"`` | ``"cuda"`` | None = eager) or instance -> instance."""
    if isinstance(backend, KernelBackend):
        return backend
    name = backend or "eager"
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; expected one of {list(BACKENDS)}")
    return EAGER if name == "eager" else CUDA
