"""General optimization framework (paper Sec. III-C, Fig. 7).

Four stages, mirroring the paper:
  1. profile  — shift-score curves -> outliers + D* (Sec. III-A / Eq. 2)
  2. parse    — analytic MAC breakdown of the target U-Net -> cost f(l)
  3. search   — enumerate {T_sketch, T_complete, T_sparse, L_sketch,
                 L_refine} under the user's constraints, maximizing the
                 MAC reduction of Eq. (3)
  4. validate — generate with each candidate and check the quality proxy
                 against the user threshold; emit valid solutions.

The port's own copy of ``repro/core/framework.py``: the MAC model and the
search are exact integer / float64 arithmetic on the config, so both
packages rank the same plans with the same numbers.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

from repro_torch.common.types import PASPlan, UNetConfig


# ---------------------------------------------------------------------------
# Analytic MAC model (stage 2: "model parser")
# ---------------------------------------------------------------------------


def _conv_macs(l: int, cin: int, cout: int, k: int) -> int:
    return l * cin * cout * k * k


def _tf_macs(l: int, c: int, ctx_len: int, ctx_dim: int) -> int:
    macs = 2 * _conv_macs(l, c, c, 1)  # proj in/out
    macs += 4 * l * c * c  # self qkvo
    macs += 2 * l * l * c  # self attention scores + values
    macs += l * c * c + 2 * ctx_len * ctx_dim * c + l * c * c  # cross q, kv, o
    macs += 2 * l * ctx_len * c  # cross attention
    macs += l * c * 8 * c + l * 4 * c * c  # GEGLU MLP
    return macs


def _res_macs(l: int, cin: int, cout: int) -> int:
    macs = _conv_macs(l, cin, cout, 3) + _conv_macs(l, cout, cout, 3)
    if cin != cout:
        macs += _conv_macs(l, cin, cout, 1)
    return macs


@dataclasses.dataclass(frozen=True)
class MACBreakdown:
    conv_in: int
    down: tuple[int, ...]  # per down entry (after conv_in)
    mid: int
    up: tuple[int, ...]  # per up step
    conv_out: int

    @property
    def total(self) -> int:
        return self.conv_in + sum(self.down) + self.mid + sum(self.up) + self.conv_out


def unet_mac_breakdown(cfg: UNetConfig) -> MACBreakdown:
    chans = [cfg.base_channels * m for m in cfg.channel_mult]
    size = cfg.latent_size
    l = size * size

    conv_in = _conv_macs(l, cfg.in_channels, cfg.base_channels, 3)

    down = []
    ch = cfg.base_channels
    cur = l
    for lvl, cout in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            m = _res_macs(cur, ch, cout)
            if lvl in cfg.attn_levels:
                m += cfg.tf_depth * _tf_macs(cur, cout, cfg.ctx_len, cfg.ctx_dim)
            down.append(m)
            ch = cout
        if lvl != cfg.n_levels - 1:
            down.append(_conv_macs(cur // 4, ch, ch, 3))
            cur //= 4

    mid = 2 * _res_macs(cur, ch, ch) + cfg.tf_depth * _tf_macs(cur, ch, cfg.ctx_len, cfg.ctx_dim)

    # up path: replay channel bookkeeping of init_unet
    skip_ch = [cfg.base_channels]
    c2 = cfg.base_channels
    for lvl, cout in enumerate(chans):
        for _ in range(cfg.n_res_blocks):
            c2 = cout
            skip_ch.append(c2)
        if lvl != cfg.n_levels - 1:
            skip_ch.append(c2)

    up = []
    ch_up = ch
    for lvl in reversed(range(cfg.n_levels)):
        cout = chans[lvl]
        cur_l = (cfg.latent_size >> lvl) ** 2
        for i in range(cfg.n_res_blocks + 1):
            sc = skip_ch.pop()
            m = _res_macs(cur_l, ch_up + sc, cout)
            if lvl in cfg.attn_levels:
                m += cfg.tf_depth * _tf_macs(cur_l, cout, cfg.ctx_len, cfg.ctx_dim)
            if i == cfg.n_res_blocks and lvl != 0:
                m += _conv_macs(cur_l * 4, cout, cout, 3)
            up.append(m)
            ch_up = cout
    conv_out = _conv_macs(l, cfg.base_channels, cfg.out_channels, 3)
    return MACBreakdown(conv_in, tuple(down), mid, tuple(up), conv_out)


def cost_function(cfg: UNetConfig) -> Callable[[int], float]:
    """f(l): fractional MAC cost of running the top-l partial U-Net.

    f(-1) (or l >= n_up+1) = 1.0 = the full network including the middle
    block (the paper's l = 13 for SD v1.4).
    """
    br = unet_mac_breakdown(cfg)
    n_up = len(br.up)

    def f(l: int) -> float:
        if l < 0 or l > n_up:
            return 1.0
        # partial-l: conv_in + (l-1) more down entries + top-l up steps
        cost = br.conv_in + sum(br.down[: l - 1]) + sum(br.up[n_up - l :]) + br.conv_out
        return cost / br.total

    return f


def mac_reduction(cfg: UNetConfig, plan: PASPlan, total_steps: int) -> float:
    """Paper Eq. (3): MAC_reduce = T / sum_t f(l_t)."""
    f = cost_function(cfg)
    return total_steps / sum(f(l) for l in plan.schedule(total_steps))


# ---------------------------------------------------------------------------
# Stage 3+4: constrained search & validation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SearchConstraints:
    total_steps: int
    d_star: int  # from phase division (T_sketch >= D*)
    n_outlier_blocks: int  # L_refine >= this
    min_quality: float  # threshold on the quality proxy (higher = better)
    t_complete_range: tuple[int, ...] = (2, 3, 4, 5)
    t_sparse_range: tuple[int, ...] = (2, 3, 4, 5, 6)
    l_sketch_range: tuple[int, ...] = ()  # default: derived from n_up
    l_refine_range: tuple[int, ...] = ()


@dataclasses.dataclass
class Solution:
    plan: PASPlan
    mac_reduction: float
    quality: float | None = None
    valid: bool | None = None


def search_plans(cfg: UNetConfig, cons: SearchConstraints) -> list[Solution]:
    """Stage 3: enumerate feasible plans, best MAC reduction first."""
    n_up = len(unet_mac_breakdown(cfg).up)
    l_sk_range = cons.l_sketch_range or tuple(range(1, n_up))
    l_rf_range = cons.l_refine_range or tuple(range(1, n_up))
    t_sketch = max(cons.d_star, 1)

    out = []
    for t_c, t_sp, l_sk, l_rf in itertools.product(
        cons.t_complete_range, cons.t_sparse_range, l_sk_range, l_rf_range
    ):
        if l_rf < cons.n_outlier_blocks or l_sk < l_rf:
            continue
        if t_c > t_sketch:
            continue
        plan = PASPlan(t_sketch, t_c, t_sp, l_sk, l_rf)
        try:
            plan.validate(cons.total_steps, n_up, cons.d_star)
        except ValueError:
            continue
        out.append(Solution(plan, mac_reduction(cfg, plan, cons.total_steps)))
    out.sort(key=lambda s: -s.mac_reduction)
    return out


def validate_solutions(
    solutions: Sequence[Solution],
    evaluate_quality: Callable[[PASPlan], float],
    min_quality: float,
    max_evals: int = 16,
) -> list[Solution]:
    """Stage 4: run the generator per candidate; keep quality-passing plans."""
    valid: list[Solution] = []
    for sol in solutions[:max_evals]:
        sol.quality = float(evaluate_quality(sol.plan))
        sol.valid = sol.quality >= min_quality
        if sol.valid:
            valid.append(sol)
    valid.sort(key=lambda s: -s.mac_reduction)
    return valid
