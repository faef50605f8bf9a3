"""Hand-written Hopper kernels for the served hot path.

One package per TPU kernel of ``repro/kernels`` that the served path runs,
each an ``ops.py`` holding the kernel's wrapper beside its plain PyTorch
version; the CUDA C++ sources live in ``csrc/`` and are built by
:mod:`repro_torch.kernels.build` at first use.  Every wrapper counts its
launches in a ``launches`` attribute, so a run can show the path went
through the kernel.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.stream_norm.ops import stream_group_norm
from repro_torch.kernels.uniconv.ops import uniconv

#: kernel name -> wrapper with a ``launches`` counter
KERNELS = {
    "uniconv": uniconv,
    "stream_group_norm": stream_group_norm,
    "flash_attention": flash_attention,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
