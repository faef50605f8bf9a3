"""Serving CLI for the PyTorch port: a synthetic txt2img request stream
through the continuous-batching engine.

Requests are built as ``repro.launch.serve`` builds them without a quality
policy: per-request prompt embeddings and noise from
``np.random.default_rng(seed * 100_003 + i)``, and the stock phase-aware
plan under ``--pas`` (else all-FULL).  ``--kernels`` picks the kernel
backend: ``cuda`` (the Hopper kernels, the default on a GPU) or ``eager``
(plain PyTorch, the only choice with ``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion --unet sd_v14 \\
      --requests 4 --batch 2 --timesteps 8 --pas
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 2 --timesteps 4
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.models import unet as U
from repro_torch.serving import config as CFG
from repro_torch.serving.engine import GenRequest
from repro_torch.serving.policy import default_pas_plan


def make_diffusion_requests(args, ucfg) -> list[GenRequest]:
    """Synthetic request stream: per-request prompt embeddings and noise."""
    n_up = U.n_up_steps(ucfg)
    L = ucfg.latent_size**2
    reqs = []
    for i in range(args.requests):
        rng = np.random.default_rng(args.seed * 100_003 + i)
        reqs.append(
            GenRequest(
                rid=i,
                ctx=rng.normal(size=(ucfg.ctx_len, ucfg.ctx_dim)).astype(np.float32),
                noise=rng.normal(size=(L, ucfg.in_channels)).astype(np.float32),
                timesteps=args.timesteps,
                plan=default_pas_plan(args.timesteps, n_up) if args.pas else None,
            )
        )
    return reqs


def serve_diffusion(args) -> dict:
    bundle = CFG.build_engine(CFG.from_args(args))
    done, summary = bundle.engine.run(make_diffusion_requests(args, bundle.ucfg))
    if sorted(r.rid for r in done) != list(range(args.requests)):
        raise RuntimeError(f"served rids {sorted(r.rid for r in done)} of {args.requests}")
    return dict(
        summary,
        mode="diffusion",
        engine="continuous",
        pas=bool(args.pas),
        image_shape=tuple(done[0].image.shape),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["diffusion"], default="diffusion")
    ap.add_argument("--unet", default="sd_toy")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="lanes of the continuous engine")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--pas", action="store_true", help="serve with phase-aware sampling")
    ap.add_argument("--window", type=int, default=4, help="plan-aware admission window")
    ap.add_argument(
        "--kernels", choices=["eager", "cuda"], default=None,
        help="kernel backend: cuda = the hand-written Hopper kernels (default on a GPU), "
        "eager = the plain PyTorch versions (default with --device cpu)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device; runs on the GPU unless 'cpu' is asked for explicitly",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(f"[serve] {serve_diffusion(args)}")


if __name__ == "__main__":
    main()
