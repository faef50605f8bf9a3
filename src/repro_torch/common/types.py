"""Model, sampler and phase-aware-sampling (PAS) plan configs.

The port's own copy of the diffusion half of ``repro/common/types.py``;
field names, defaults and plan semantics are identical.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    n_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (0, 1, 2)  # levels with transformer blocks
    n_heads: int = 8
    tf_depth: int = 1  # transformer blocks per attention site
    ctx_dim: int = 768  # text-conditioning width
    ctx_len: int = 77
    time_dim: int = 1280
    groups: int = 32
    latent_size: int = 64  # spatial size of the latent
    #: storage type of the weights; activations are always float32, and
    #: "bfloat16" weights are held as float32 tensors of bf16-rounded values
    dtype: str = "float32"

    @property
    def n_levels(self) -> int:
        return len(self.channel_mult)

    @property
    def n_skip_blocks(self) -> int:
        """Number of paper-indexed down/up block pairs (Fig. 3: 12 for SD)."""
        return 1 + self.n_levels * self.n_res_blocks + (self.n_levels - 1)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps_train: int = 1000
    timesteps_sample: int = 50
    scheduler: str = "pndm"  # "ddim" | "pndm"
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    guidance_scale: float = 7.5


@dataclasses.dataclass(frozen=True)
class PASPlan:
    """{T_sketch, T_complete, T_sparse, L_sketch, L_refine} of the paper."""

    t_sketch: int
    t_complete: int
    t_sparse: int
    l_sketch: int
    l_refine: int

    def validate(self, total_steps: int, n_blocks: int, d_star: int | None = None):
        if not (0 < self.t_complete <= self.t_sketch <= total_steps):
            raise ValueError("need 0 < T_complete <= T_sketch <= T")
        if self.t_sparse < 1:
            raise ValueError("T_sparse >= 1")
        if not (0 < self.l_refine <= self.l_sketch <= n_blocks):
            raise ValueError("need 0 < L_refine <= L_sketch <= n_blocks")
        if d_star is not None and self.t_sketch < d_star:
            raise ValueError(
                f"T_sketch={self.t_sketch} must be >= D*={d_star} (paper Sec. III-B)"
            )

    def schedule(self, total_steps: int) -> list[int]:
        """Per-timestep block budget l_t. -1 denotes a full U-Net run."""
        out = []
        for t in range(total_steps):
            if t < self.t_complete:
                out.append(-1)
            elif t < self.t_sketch:
                since = t - self.t_complete
                out.append(-1 if (since + 1) % self.t_sparse == 0 else self.l_sketch)
            else:
                out.append(self.l_refine)
        return out
