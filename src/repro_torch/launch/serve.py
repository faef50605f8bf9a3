"""Serving CLI for the PyTorch port: a synthetic txt2img request stream
through the continuous-batching engine or the static lockstep baseline.

Requests are built as ``repro.launch.serve`` builds them: per-request prompt
embeddings and noise from ``np.random.default_rng(seed * 100_003 + i)``;
with ``--quality`` every request resolves its plan and cache thresholds
through the quality policy (``repro_torch.serving.policy``), else ``--pas``
picks the stock phase-aware plan (without it, all-FULL).

``--cache {off,intra,cross}`` arms the feature cache on the continuous
engine (``intra``: a request reuses its own FULL-step captures; ``cross``:
requests with close prompts and timesteps reuse each other's), with
``--cache-threshold`` as the quality/reuse knob (0 = bit-exact with
``off``) and ``--cache-spill-mb`` a host-RAM ring under the device slots.
``--engine static`` serves fixed-size lockstep batches instead.
``--kernels`` picks the kernel backend: ``cuda`` (the Hopper kernels, the
default on a GPU) or ``eager`` (plain PyTorch, the only choice with
``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion --unet sd_v14 \\
      --requests 4 --batch 2 --timesteps 8 --cache cross --quality draft
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --engine static --pas
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.models import unet as U
from repro_torch.serving import config as CFG
from repro_torch.serving.engine import GenRequest, serve_static
from repro_torch.serving.policy import QualityPolicy, default_pas_plan


def make_diffusion_requests(args, ucfg, policy: QualityPolicy | None = None) -> list[GenRequest]:
    """Synthetic request stream: per-request prompt embeddings and noise.

    With a ``policy`` every request resolves its plan (and, under
    ``--quality``, its cache thresholds) through it; otherwise ``--pas``
    picks the stock plan and the engine threshold applies.
    """
    n_up = U.n_up_steps(ucfg)
    L = ucfg.latent_size**2
    quality = getattr(args, "quality", None)
    reqs = []
    for i in range(args.requests):
        rng = np.random.default_rng(args.seed * 100_003 + i)
        if policy is not None:
            pol = policy.resolve(args.timesteps, quality=quality, pas=args.pas)
            plan = pol.plan
        else:
            pol, plan = None, default_pas_plan(args.timesteps, n_up) if args.pas else None
        reqs.append(
            GenRequest(
                rid=i,
                ctx=rng.normal(size=(ucfg.ctx_len, ucfg.ctx_dim)).astype(np.float32),
                noise=rng.normal(size=(L, ucfg.in_channels)).astype(np.float32),
                timesteps=args.timesteps,
                plan=plan,
                policy=pol,
            )
        )
    return reqs


def serve_diffusion(args) -> dict:
    engine_kind = getattr(args, "engine", "continuous")
    if engine_kind == "static":
        if getattr(args, "cache", "off") != "off":
            raise SystemExit(
                "--cache requires the continuous engine (lockstep batches have "
                "no per-lane micro-steps to demote); drop --engine static or --cache"
            )
        if getattr(args, "profile", None):
            raise SystemExit(
                "--profile requires the continuous engine (calibrated thresholds "
                "drive the feature cache, which lockstep batches don't have); "
                "drop --engine static or --profile"
            )
        cfg = CFG.from_args(args)
        ucfg, dcfg, params, vae_params = CFG.init_models(cfg)
        policy = QualityPolicy(U.n_up_steps(ucfg))
        quality = getattr(args, "quality", None)
        reqs = make_diffusion_requests(args, ucfg, policy)
        # lockstep batches share one plan per step count, resolved through
        # the same policy the continuous engine uses
        plan_fn = lambda t: policy.resolve(t, quality=quality, pas=args.pas).plan  # noqa: E731
        done, summary = serve_static(
            ucfg, dcfg, params, vae_params, reqs, args.batch, plan_fn=plan_fn,
            backend=cfg.backend, device=cfg.device,
        )
    else:
        bundle = CFG.build_engine(CFG.from_args(args))
        reqs = make_diffusion_requests(args, bundle.ucfg, bundle.policy)
        done, summary = bundle.engine.run(reqs)
    if sorted(r.rid for r in done) != list(range(args.requests)):
        raise RuntimeError(f"served rids {sorted(r.rid for r in done)} of {args.requests}")
    return dict(
        summary,
        mode="diffusion",
        engine=engine_kind,
        pas=bool(args.pas),
        image_shape=tuple(done[0].image.shape),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["diffusion"], default="diffusion")
    ap.add_argument("--unet", default="sd_toy")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="lanes (continuous) / batch (static)")
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--pas", action="store_true", help="serve with phase-aware sampling")
    ap.add_argument(
        "--quality", default=None, metavar="TIER|Q",
        help="per-request quality knob: a named tier (draft|balanced|high|exact) or "
        "a number in [0,1]; decides the PAS plan shape and the cache threshold per "
        "request (exact = all-FULL + threshold 0 = bit-exact)",
    )
    ap.add_argument(
        "--profile", default=None, metavar="PATH",
        help="shift-score calibration profile (.npz); refines the quality tiers' "
        "cache thresholds per timestep bucket",
    )
    ap.add_argument(
        "--engine", choices=["continuous", "static"], default="continuous",
        help="step-level continuous batching vs fixed-size lockstep batches",
    )
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
    ap.add_argument(
        "--cache", choices=["off", "intra", "cross"], default="off",
        help="feature cache: intra = a request reuses its own captures, cross = "
        "requests reuse each other's (continuous engine only)",
    )
    ap.add_argument(
        "--cache-threshold", type=float, default=0.15,
        help="prompt-signature shift-score bound for a cache hit (0 = never hit)",
    )
    ap.add_argument("--cache-slots", type=int, default=16, help="feature-cache ring size")
    ap.add_argument(
        "--cache-bucket", type=int, default=125,
        help="timestep bucket width (train-timestep units) for cache keys",
    )
    ap.add_argument(
        "--cache-spill-mb", type=float, default=0.0,
        help="host-RAM spill ring budget in MiB (0 = off): ring evictions demote "
        "there and admission promotes matches back onto the device",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(f"[serve] {serve_diffusion(args)}")


if __name__ == "__main__":
    main()
