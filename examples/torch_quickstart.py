"""Quickstart on the PyTorch port: the paper's pipeline in ~60 lines.

1. Build a StableDiff-family U-Net (random weights from a seed).
2. Run the ORIGINAL sampler (full U-Net every step).
3. Run the same sampler under PHASE-AWARE SAMPLING (PAS).
4. Report the MAC reduction (paper Eq. 3) and output fidelity.

Runs on the GPU with the Hopper kernels unless ``--device cpu`` asks for the
plain PyTorch path on the CPU.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--timesteps 20] [--unet sd_v14]
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.configs import get_unet_config
from repro_torch.core import framework as FW
from repro_torch.core import sampler as SM
from repro_torch.core.metrics import latent_cosine, latent_psnr
from repro_torch.models import unet as U
from repro_torch.serving.engine import resolve_kernels, torch_device


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_n_params(v) for v in tree)
    return tree.numel()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timesteps", type=int, default=20, help="denoise steps")
    ap.add_argument("--unet", default="sd_toy", help="U-Net config name")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device; runs on the GPU unless 'cpu' is asked for explicitly",
    )
    args = ap.parse_args(argv)

    device = torch_device(args.device)
    backend = resolve_kernels(args.device, None)
    ucfg = get_unet_config(args.unet)
    dcfg = DiffusionConfig(timesteps_sample=args.timesteps)
    gen = torch.Generator(device=device).manual_seed(0)

    params = U.init_unet(ucfg, gen)
    print(f"U-Net: {_n_params(params)/1e6:.1f}M params, {U.n_up_steps(ucfg)} up-blocks, "
          f"{backend} kernels on {device}")

    # a batch of two "prompts" (context embeddings; the text encoder is the
    # stubbed frontend, as in the JAX package)
    b, L = 2, ucfg.latent_size**2
    noise = torch.randn((b, L, ucfg.in_channels), generator=gen, device=device)
    ctx = torch.randn((b, ucfg.ctx_len, ucfg.ctx_dim), generator=gen, device=device) * 0.3
    uncond = torch.zeros_like(ctx)

    t = dcfg.timesteps_sample
    n_up = U.n_up_steps(ucfg)
    plan = PASPlan(
        t_sketch=max(1, t // 2), t_complete=min(max(1, t // 2), 2), t_sparse=3,
        l_sketch=min(3, n_up), l_refine=min(2, n_up),
    )
    plan.validate(t, n_up)
    with torch.no_grad():
        print("\n[1/2] original sampler (full U-Net every step)...")
        full = SM.pas_denoise(ucfg, dcfg, params, None, noise, ctx, uncond, backend=backend)
        print("[2/2] phase-aware sampling...")
        pas = SM.pas_denoise(ucfg, dcfg, params, plan, noise, ctx, uncond, backend=backend)

    red = FW.mac_reduction(ucfg, plan, t)
    print(f"\nMAC reduction (Eq. 3):  {red:.2f}x")
    print(f"PSNR vs full sampler:   {latent_psnr(pas, full):.1f} dB")
    print(f"cosine vs full sampler: {latent_cosine(pas, full):.4f}")
    print(f"schedule (block budget per step, -1 = full): {plan.schedule(t)}")


if __name__ == "__main__":
    main()
