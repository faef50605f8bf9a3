"""Hand-written Hopper kernels, one for each TPU kernel of ``repro/kernels``.

One package per TPU kernel, each an ``ops.py`` holding the kernel's wrapper
beside its plain PyTorch version; the CUDA C++ sources live in ``csrc/`` and
are built by :mod:`repro_torch.kernels.build` at first use.  The served path
runs three of them (``uniconv``, ``stream_group_norm``, ``flash_attention``)
through :mod:`repro_torch.models.backend`; ``stream_norm`` and
``fused_matmul`` are reached only through :data:`KERNEL_REGISTRY`, as in the
JAX package.  Every wrapper counts its launches in a ``launches`` attribute,
so a run can show the path went through the kernel.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
from repro_torch.kernels.fused_matmul.ops import fused_matmul, fused_matmul_plain
from repro_torch.kernels.stream_norm.ops import (
    stream_group_norm,
    stream_group_norm_plain,
    stream_norm,
    stream_norm_plain,
)
from repro_torch.kernels.uniconv.ops import uniconv, uniconv_plain

#: kernel name -> (kernel wrapper with a ``launches`` counter, plain version
#: taking the same arguments); the names of ``repro.kernels.KERNEL_REGISTRY``
KERNEL_REGISTRY = {
    "uniconv": (uniconv, uniconv_plain),
    "flash_attention": (flash_attention, flash_attention_ref),
    "stream_norm": (stream_norm, stream_norm_plain),
    "stream_group_norm": (stream_group_norm, stream_group_norm_plain),
    "fused_matmul": (fused_matmul, fused_matmul_plain),
}

__all__ = [
    "KERNEL_REGISTRY",
    "flash_attention",
    "fused_matmul",
    "launch_counts",
    "reset_launch_counts",
    "stream_group_norm",
    "stream_norm",
    "uniconv",
]


def reset_launch_counts() -> None:
    for fn, _ in KERNEL_REGISTRY.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, (fn, _) in KERNEL_REGISTRY.items()}
