"""The paper's general optimization framework (Sec. III-C, Fig. 7) on the
PyTorch port, end to end:

  step 1  profile   — sample with feature capture, compute shift scores
                      (Eq. 1), detect outlier blocks, find D* (Eq. 2)
  step 2  parse     — MAC breakdown -> cost function f(l) (Fig. 6)
  step 3  search    — enumerate PAS plans under the constraints (Eq. 3)
  step 4  validate  — generate with each candidate, check the quality
                      proxy, emit the best valid plan

Weights are random, from seed 0; each calibration batch holds two prompts
(prompt embeddings and noise from ``torch.Generator(batch index + 1)``).
It runs on the GPU with the Hopper kernels unless ``--device cpu`` asks for
the plain PyTorch path on the CPU.  The emitted ``--profile-out`` file closes
the calibrate -> serve loop inside the port: the serving quality policy
(``repro_torch.serving.policy``) loads it to refine the per-request cache
thresholds per timestep bucket, e.g.::

  PYTHONPATH=src python examples/torch_pas_calibration.py --unet sd_v14 \\
      --profile-out profile.npz
  PYTHONPATH=src python -m repro_torch.launch.serve --unet sd_v14 \\
      --quality balanced --profile profile.npz --cache cross

Run:  PYTHONPATH=src python examples/torch_pas_calibration.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import get_unet_config
from repro_torch.core import framework as FW
from repro_torch.core import phase_division as PD
from repro_torch.core import sampler as SM
from repro_torch.core import shift_score as SS
from repro_torch.core.metrics import latent_cosine
from repro_torch.models import diffusion as D
from repro_torch.models import unet as U
from repro_torch.serving.engine import resolve_kernels, torch_device

#: prompts in one calibration batch (CFG batch twice that)
BATCH = 2
#: the quality bar of stage 4 (cosine against the all-FULL sampler)
MIN_QUALITY = 0.90


def prompt_batch(ucfg, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(prompt embeddings * 0.3, noise) of one batch, from ``torch.Generator(seed)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = torch.randn((BATCH, ucfg.ctx_len, ucfg.ctx_dim), generator=gen, device=device) * 0.3
    noise = torch.randn(
        (BATCH, ucfg.latent_size**2, ucfg.in_channels), generator=gen, device=device
    )
    return ctx, noise


def profile_prompts(ucfg, dcfg, params, n_cal: int, device, backend):
    """Stage 1 over ``n_cal`` batches -> (profile, [(final latent, raw scores)]).

    Each batch's trajectory is scored, then dropped before the next batch
    runs: at sd_v14 one holds 139 MiB of captures per step."""
    n_up = U.n_up_steps(ucfg)
    runs = []
    for i in range(n_cal):
        ctx, noise = prompt_batch(ucfg, i + 1, device)
        x0, traj = SM.denoise_with_capture(
            ucfg, dcfg, params, noise, ctx, torch.zeros_like(ctx),
            capture_steps=tuple(range(n_up)), backend=backend,
        )
        runs.append((x0.to("cpu"), SS.shift_scores(traj)))
        del traj
    return SS.build_profile([s for _, s in runs]), runs


def plan_constraints(total: int, profile: SS.ShiftProfile, d_star: int) -> FW.SearchConstraints:
    """Stage 3's constraints: T_sketch >= D*, L_refine >= the outlier count.

    The T_complete range stays feasible at short calibration schedules,
    where D* (and with it the T_complete <= T_sketch bound) can sit at 1."""
    return FW.SearchConstraints(
        total_steps=total,
        d_star=d_star,
        n_outlier_blocks=max(len(profile.outlier_blocks), 1),
        min_quality=MIN_QUALITY,
        t_complete_range=tuple(t for t in (1, 2, 3) if t <= max(d_star, 1)),
        t_sparse_range=(2, 3, 4),
    )


def validate_plans(ucfg, dcfg, params, sols, min_quality: float, device, backend,
                   max_evals: int = 6) -> list[FW.Solution]:
    """Stage 4: each candidate's latent against the all-FULL sampler's on one
    held-out batch (prompt from seed 99, noise from seed 100), by cosine."""
    ctx, _ = prompt_batch(ucfg, 99, device)
    _, noise = prompt_batch(ucfg, 100, device)
    un = torch.zeros_like(ctx)
    full = SM.pas_denoise(ucfg, dcfg, params, None, noise, ctx, un, backend=backend)

    def quality(plan):
        out = SM.pas_denoise(ucfg, dcfg, params, plan, noise, ctx, un, backend=backend)
        return latent_cosine(out, full)

    return FW.validate_solutions(sols, quality, min_quality, max_evals=max_evals)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timesteps", type=int, default=16, help="calibration denoise steps")
    ap.add_argument("--prompts", type=int, default=3,
                    help=f"calibration batches ({BATCH} prompts each)")
    ap.add_argument("--unet", default="sd_toy", help="U-Net config name")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device; runs on the GPU unless 'cpu' is asked for explicitly",
    )
    ap.add_argument(
        "--profile-out", default=None, metavar="PATH",
        help="save the shift-score profile (.npz) the serving quality policy "
        "loads (repro_torch.launch.serve --profile)",
    )
    args = ap.parse_args(argv)

    device = torch_device(args.device)
    backend = resolve_kernels(args.device, None)
    ucfg = get_unet_config(args.unet)
    dcfg = DiffusionConfig(timesteps_sample=args.timesteps)
    total = dcfg.timesteps_sample
    params = U.init_unet(ucfg, torch.Generator(device=device).manual_seed(0))
    n_up = U.n_up_steps(ucfg)

    print(f"[1/4] profiling {args.prompts} calibration batches on {device} "
          f"({backend} kernels) ...")
    with torch.no_grad():
        profile, _ = profile_prompts(ucfg, dcfg, params, args.prompts, device, backend)
    d_star = PD.find_transition(profile)
    stats = PD.phase_stats(profile, d_star)
    print(f"    D* = {d_star}  mu_sketch={stats['mu_sketch']:.3f} "
          f"mu_refine={stats['mu_refine']:.3f} outliers={profile.outlier_blocks}")
    if args.profile_out:
        SS.save_profile(args.profile_out, profile, ts=D.sample_timesteps(dcfg).numpy())
        print(f"    profile saved to {args.profile_out} "
              f"(load with repro_torch.launch.serve --profile)")

    print("[2/4] parsing the model -> cost function f(l) ...")
    f = FW.cost_function(ucfg)
    print("    f(l) =", [round(f(l), 3) for l in range(1, n_up + 1)])

    print("[3/4] searching PAS plans under constraints ...")
    cons = plan_constraints(total, profile, d_star)
    sols = FW.search_plans(ucfg, cons)
    if not sols:
        print("    no feasible plan under the constraints; relax them "
              "(short calibration schedules can pin D* to 1)")
        return
    print(f"    {len(sols)} feasible plans; best MAC reduction "
          f"{sols[0].mac_reduction:.2f}x")

    print("[4/4] validating candidates against the quality proxy ...")
    with torch.no_grad():
        valid = validate_plans(ucfg, dcfg, params, sols, cons.min_quality, device, backend)
    if not valid:
        print("    no plan met the quality bar; relax constraints")
        return
    best = valid[0]
    print(f"\nBEST PLAN: {best.plan}")
    print(f"  MAC reduction {best.mac_reduction:.2f}x at quality {best.quality:.4f}")


if __name__ == "__main__":
    main()
