"""Production meshes, and the H100 constants of the roofline model.

The port's copy of ``repro/launch/mesh.py``.  The meshes keep the
reference's shapes and axis names, so each leaf's layout can be held
against the reference's: one pod of 16 x 16 = 256 devices and two pods of
512.  On H100s they are 32 or 64 hosts of 8 cards.  A mesh here is a
description with no devices (``common.types.Mesh``): the dry run costs
a step on ``meta`` tensors and never touches a card.

The H100 constants are the port's one copy of the card's peaks:
``chip_smoke.py`` reads its bounds from here.  The module imports no torch.
"""
from __future__ import annotations

from repro_torch.common.types import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh() -> Mesh:
    """Degenerate 1-device mesh: one card, through the same code path."""
    return Mesh((1, 1), ("data", "model"))


# H100 SXM constants for the roofline model (per card)
#: dense bfloat16 on the tensor cores at 700 W (NVIDIA H100 SXM data sheet)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
#: dense TF32 on the tensor cores (NVIDIA H100 SXM data sheet)
PEAK_FLOPS_TF32 = 495e12  # FLOP/s
#: float32 on the CUDA cores, no tensor cores (NVIDIA H100 SXM data sheet)
PEAK_FLOPS_FP32 = 67e12  # FLOP/s
#: HBM3 rate (NVIDIA H100 SXM data sheet)
HBM_BW = 3.35e12  # B/s
#: the slowest link of any ring on a 16 x 16 mesh of 8-card hosts: one
#: 400 Gb/s NDR InfiniBand NIC per card (NVIDIA DGX H100 data sheet)
LINK_BW = 50e9  # B/s
#: NVLink 4 inside a host, each way per card (NVIDIA H100 SXM data sheet:
#: 900 GB/s bidirectional); a ring over more than one host runs at LINK_BW
NVLINK_BW = 450e9  # B/s
#: ``torch.cuda.get_device_properties(0).total_memory`` of an H100 80GB
#: HBM3 (read by chip_smoke.py phase 14), not the nominal 80 GB: "fits"
#: means fits in the memory torch sees
HBM_BYTES = 85_017_493_504
