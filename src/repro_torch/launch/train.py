"""Training driver of the PyTorch port (``repro/launch/train.py``).

Two modes, chosen by ``--mode``:

* ``lm``: train an LM arch (``--arch``, ``--variant smoke|full``) on the
  synthetic token stream: the transformer family, xlstm (``ssm``) and
  hymba (``hybrid``).
* ``unet``: train a StableDiff U-Net with the eps-prediction diffusion
  objective on structured synthetic latents (the ``train_unet`` example
  runs this path).

Production posture wired in: the host-sharded data pipeline with async
prefetch, checkpoint / restart with atomic commits
(``repro_torch.checkpoint``), the SIGTERM preemption guard and straggler
detection (``--mode lm``), optional error-feedback int8 gradient
compression (``--mode unet``).

The U-Net step differentiates the ``eager`` backend with autograd: the
Hopper kernels have no backward (nor have the JAX package's, whose trainer
runs its ``xla`` backend), and their wrappers refuse an operand that
requires grad.  The random draws of a step, timesteps and noise, come from
an explicit ``torch.Generator`` on the device (:func:`draw_noise`) and
enter the step as tensors, so a test can feed it the JAX package's draws.
The LM path calls no kernel of ``repro_torch.kernels``, as the reference's
calls no Pallas kernel.

Runs on the GPU unless ``--device cpu`` asks for the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --unet sd_v14 --steps 4 --batch 2 \\
      --ckpt-dir build/ckpt --save-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm --arch yi-6b --variant smoke \\
      --steps 20 --batch 2 --seq 16 --device cpu --ckpt-dir build/lm_ckpt --save-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm --arch gemma3-1b --variant full \\
      --batch 2 --seq 1024 --steps 6
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.tree import tree_leaves, tree_unflatten
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import ARCH_IDS, get_lm_config, get_unet_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, latent_batch, token_batch
from repro_torch.launch.steps import get_adapter, make_train_step
from repro_torch.models import diffusion as D
from repro_torch.models import unet as U
from repro_torch.optim import (
    AdamWConfig,
    adamw_update,
    compressed_grads,
    init_adamw,
    init_compression,
)
from repro_torch.runtime.fault_tolerance import PreemptionGuard, StragglerDetector
from repro_torch.serving.engine import torch_device

#: classes of the synthetic latents; the context is their one-hot row
N_CLASSES = 8


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------


def train_lm(args) -> dict:
    """Train ``args.arch`` (``args.variant``) for ``args.steps`` steps on
    ``token_batch``'s stream (batch ``args.batch``, ``args.seq`` tokens),
    resuming from the newest checkpoint in ``args.ckpt_dir``.  Returns the
    first and last loss, the step it started from, each step's host wall
    seconds (the loss read back, so the card is synchronised) and the
    final ``{"params", "opt"}`` state."""
    device = torch_device(args.device)
    cfg = get_lm_config(args.arch, args.variant)
    adapter = get_adapter(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5 + 1))

    params = adapter.init(torch.Generator(device=device).manual_seed(args.seed), device)
    print(f"[train] arch={args.arch} variant={args.variant} params={_n_params(params)/1e6:.1f}M "
          f"dtype={cfg.dtype}")
    opt = init_adamw(params)
    step_fn = make_train_step(adapter, opt_cfg, remat=False)

    dc = DataConfig(global_batch=args.batch, seq_len=args.seq + 1, vocab_size=cfg.vocab_size,
                    seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    state = {"params": params, "opt": opt}
    start = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            start, state = restored
            print(f"[train] resumed from step {start}")

    guard = PreemptionGuard(install=not args.no_sigterm)
    strag = StragglerDetector()
    losses, step_s = [], []
    pre = Prefetcher(lambda s: token_batch(dc, s), start_step=start)
    try:
        for step in range(start, args.steps):
            _, np_batch = next(pre)
            batch = {"inputs": torch.from_numpy(np_batch["tokens"]).to(device),
                     "labels": torch.from_numpy(np_batch["labels"]).to(device)}
            t0 = time.perf_counter()
            state["params"], state["opt"], loss = step_fn(state["params"], state["opt"], batch)
            loss = float(loss)  # waits for the step's last kernel
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_s.append(dt)
            if strag.observe(step, dt):
                print(f"[train] straggler step={step} dt={dt:.3f}s")
            if step % args.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} dt={dt*1e3:.1f}ms")
            if guard.requested and ckpt is not None:
                ckpt.save(step + 1, state, extra={"preempted": True})
                print(f"[train] preempted; checkpointed step {step+1}")
                break
            if ckpt is not None and (step + 1) % args.save_every == 0:
                ckpt.save(step + 1, state)
    finally:
        pre.close()
    nan = float("nan")
    return {"final_loss": losses[-1] if losses else nan,
            "first_loss": losses[0] if losses else nan,
            "start_step": start, "step_s": step_s, "state": state}


# ---------------------------------------------------------------------------
# U-Net diffusion training
# ---------------------------------------------------------------------------


def draw_noise(dcfg: DiffusionConfig, gen: torch.Generator, x0: torch.Tensor):
    """(timesteps [B], noise like ``x0``) of one training step, from ``gen``."""
    t = torch.randint(0, dcfg.timesteps_train, (x0.shape[0],), generator=gen, device=x0.device)
    eps = torch.randn(x0.shape, generator=gen, device=x0.device, dtype=x0.dtype)
    return t, eps


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held as float32 (a no-op for float32)."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def make_unet_train_step(ucfg, dcfg, opt_cfg, *, compress: bool = False, backend="eager"):
    """``step(params, opt, comp, batch, t, eps) -> (params, opt, comp, loss)``.

    A bfloat16 leaf of the JAX package's tree gets a bfloat16 gradient (the
    cotangent of its cast to float32 is rounded) and its updated value is
    cast back to bfloat16.  The port holds the leaf as float32, so the step
    rounds both, the gradient before the clip and the global norm."""
    dtypes = tree_leaves(U.param_dtypes(ucfg))
    schedules: dict[torch.device, D.NoiseSchedule] = {}

    def loss_fn(params, batch, t, eps):
        x0 = batch["latents"]  # [B, L, C]
        if x0.device not in schedules:
            schedules[x0.device] = D.make_schedule(dcfg, device=x0.device)
        x_t = D.q_sample(schedules[x0.device], x0, t, eps)
        pred = U.unet_apply(ucfg, params, x_t, t, batch["ctx"], backend=backend)[0]
        return torch.mean((pred - eps) ** 2)

    def step(params, opt, comp, batch, t, eps):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, live), batch, t, eps)
            grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            grads = tree_unflatten(params, [_round(g, d) for g, d in zip(grads, dtypes)])
            if compress:
                grads, comp = compressed_grads(grads, comp)
            params, opt = adamw_update(opt_cfg, params, grads, opt)
            params = tree_unflatten(
                params, [_round(p, d) for p, d in zip(tree_leaves(params), dtypes)])
        return params, opt, comp, loss.detach()

    return step


def class_context(ucfg, class_id: np.ndarray) -> np.ndarray:
    """Class-conditioned context stub: each row the one-hot of its class,
    padded (or cut) to ``ctx_dim``, repeated over ``ctx_len``."""
    ctx = np.eye(N_CLASSES, dtype=np.float32)[class_id % N_CLASSES][:, None, :]
    ctx = ctx.repeat(ucfg.ctx_len, axis=1)
    if ucfg.ctx_dim > N_CLASSES:
        return np.pad(ctx, ((0, 0), (0, 0), (0, ucfg.ctx_dim - N_CLASSES)))
    return ctx[..., : ucfg.ctx_dim]


def _n_params(tree) -> int:
    return sum(p.numel() for p in tree_leaves(tree))


def train_unet(args) -> dict:
    """Train ``args.unet`` for ``args.steps`` steps, resuming from the newest
    checkpoint in ``args.ckpt_dir``.  Returns the first loss, the mean of
    the last 10, the step it started from, each step's host wall seconds
    (the loss read back, so the card is synchronised) and the final
    ``{"params", "opt"}`` state."""
    device = torch_device(args.device)
    ucfg = get_unet_config(args.unet)
    dcfg = DiffusionConfig()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(20, args.steps // 5 + 1))
    params = U.init_unet(ucfg, torch.Generator(device=device).manual_seed(args.seed))
    print(f"[train] unet={args.unet} params={_n_params(params)/1e6:.1f}M")

    opt = init_adamw(params)
    comp = init_compression(params) if args.compress_grads else None
    step_fn = make_unet_train_step(ucfg, dcfg, opt_cfg, compress=args.compress_grads)

    dc = DataConfig(global_batch=args.batch, seq_len=0, vocab_size=N_CLASSES, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    state = {"params": params, "opt": opt}
    start = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            start, state = restored
            print(f"[train] resumed from step {start}")
    params, opt = state["params"], state["opt"]

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    losses, step_s = [], []
    for step in range(start, args.steps):
        nb = latent_batch(dc, step, size=ucfg.latent_size)
        batch = {
            "latents": torch.from_numpy(nb["latents"]).to(device),
            "ctx": torch.from_numpy(class_context(ucfg, nb["class_id"])).to(device),
        }
        t, eps = draw_noise(dcfg, gen, batch["latents"])
        t0 = time.perf_counter()
        params, opt, comp, loss = step_fn(params, opt, comp, batch, t, eps)
        losses.append(float(loss))  # waits for the step's last kernel
        step_s.append(time.perf_counter() - t0)
        if step % args.log_every == 0:
            print(f"[train] step={step} loss={losses[-1]:.4f} dt={step_s[-1] * 1e3:.1f}ms")
        if ckpt is not None and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt})
    return {"first_loss": losses[0], "final_loss": float(np.mean(losses[-10:])),
            "start_step": start, "step_s": step_s, "state": {"params": params, "opt": opt}}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["lm", "unet"], default="unet")
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-6b", help="LM arch (--mode lm)")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--unet", default="sd_toy")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length (--mode lm)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true", help="(--mode unet)")
    ap.add_argument("--no-sigterm", action="store_true",
                    help="leave SIGTERM alone (--mode lm; by default it checkpoints and stops)")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device; runs on the GPU unless 'cpu' is asked for explicitly",
    )
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    res = train_lm(args) if args.mode == "lm" else train_unet(args)
    print(f"[train] done: { {k: res[k] for k in ('first_loss', 'final_loss')} }")


if __name__ == "__main__":
    main()
