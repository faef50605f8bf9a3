"""End-to-end driver on the PyTorch port: train a ~100M-parameter
StableDiff-family U-Net on structured synthetic latents, with
checkpointing, then restore it and generate with both the original and the
PAS sampler.

The twin of ``examples/train_unet.py``.  The 'sd_100m' config is the
paper's architecture scaled to ~100M params (base 128, 3 levels).
Training differentiates the plain PyTorch path (the Hopper kernels have no
backward); sampling runs the ``--kernels`` backend, the hand-written
Hopper kernels by default.  Everything runs on the GPU unless ``--device
cpu`` asks for the CPU.

Run:  PYTHONPATH=src python examples/torch_train_unet.py [--steps 300]
      PYTHONPATH=src python examples/torch_train_unet.py --device cpu --unet sd_toy --steps 30
"""
import argparse
import sys

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.types import DiffusionConfig, PASPlan
from repro_torch.configs import get_unet_config
from repro_torch.core import framework as FW
from repro_torch.core import sampler as SM
from repro_torch.core.metrics import latent_cosine
from repro_torch.launch.train import train_unet
from repro_torch.models import unet as U
from repro_torch.optim import init_adamw
from repro_torch.serving.engine import torch_device

#: the sampling half: 20 steps, all-FULL against this plan
SAMPLE_STEPS = 20
PLAN = PASPlan(t_sketch=10, t_complete=2, t_sparse=3, l_sketch=3, l_refine=2)


def train(args) -> dict:
    """The training driver in unet mode; exits non-zero unless the loss fell."""
    drv = argparse.Namespace(
        unet=args.unet, steps=args.steps, batch=args.batch, lr=2e-4, seed=0,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every, log_every=20,
        compress_grads=args.compress_grads, device=args.device,
    )
    res = train_unet(drv)
    print(f"[example] training: first_loss={res['first_loss']:.4f} "
          f"final_loss={res['final_loss']:.4f}")
    if not res["final_loss"] < res["first_loss"]:
        sys.exit("training did not reduce the loss")
    return res


def restore(ucfg, ckpt_dir: str, device) -> tuple[int, dict]:
    """(step, params) of the newest checkpoint in ``ckpt_dir``."""
    params0 = U.init_unet(ucfg, torch.Generator(device=device).manual_seed(0))
    step, state = CheckpointManager(ckpt_dir).restore_latest(
        {"params": params0, "opt": init_adamw(params0)})
    print(f"[example] restored step {step}")
    return step, state["params"]


def sample(ucfg, params, device, backend) -> tuple[torch.Tensor, torch.Tensor]:
    """(all-FULL latents, PAS latents) of two prompts at :data:`SAMPLE_STEPS`."""
    dcfg = DiffusionConfig(timesteps_sample=SAMPLE_STEPS)
    b, L = 2, ucfg.latent_size**2
    gen = torch.Generator(device=device).manual_seed(1)
    noise = torch.randn((b, L, ucfg.in_channels), generator=gen, device=device)
    ctx = torch.zeros((b, ucfg.ctx_len, ucfg.ctx_dim), device=device)
    with torch.no_grad():
        full = SM.pas_denoise(ucfg, dcfg, params, None, noise, ctx, ctx, backend=backend)
        pas = SM.pas_denoise(ucfg, dcfg, params, PLAN, noise, ctx, ctx, backend=backend)
    return full, pas


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--unet", default="sd_100m", help="U-Net config name")
    ap.add_argument("--ckpt-dir", default="build/torch_unet_ckpt")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true",
                    help="error-feedback int8 gradient compression")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device; runs on the GPU unless 'cpu' is asked for explicitly",
    )
    ap.add_argument(
        "--kernels", choices=["eager", "cuda"], default="cuda",
        help="kernel backend of the sampling half: cuda = the hand-written Hopper "
        "kernels (the plain versions on a CPU tensor), eager = plain PyTorch",
    )
    args = ap.parse_args(argv)

    device = torch_device(args.device)
    ucfg = get_unet_config(args.unet)
    train(args)
    _, params = restore(ucfg, args.ckpt_dir, device)
    full, pas = sample(ucfg, params, device, args.kernels)
    print(f"[example] PAS vs full cosine={latent_cosine(pas, full):.4f} "
          f"MAC_red={FW.mac_reduction(ucfg, PLAN, SAMPLE_STEPS):.2f}x")


if __name__ == "__main__":
    main()
