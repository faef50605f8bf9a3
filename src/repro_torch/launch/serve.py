"""Serving CLI for the PyTorch port: a synthetic txt2img request stream
through the continuous-batching engine or the static lockstep baseline, or
the continuous engine served over HTTP; ``--mode lm`` serves an LM arch.

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

``--shards N`` splits the continuous engine's lanes into N shards, shard d
on card d (every shard on the CPU with ``--device cpu``), each with its own
branch vote and its own slot ring over one shared spill ring; it refuses N
beyond the visible cards.  ``--cache-gossip`` (the default) admits a warm
request to the shard whose ring holds its slots; ``--no-cache-gossip``
admits to the emptiest shard only.

``--http HOST:PORT`` serves the continuous engine over the asyncio HTTP
frontend (``repro_torch.serving.frontend``) instead of running a synthetic
batch: the engine runs on a driver thread, requests arrive as ``POST
/generate`` and stream per-step progress as NDJSON, ``POST /cancel`` aborts
mid-denoise, backpressure past ``--max-inflight`` answers 429, and
SIGINT/SIGTERM (or ``POST /shutdown``) drain gracefully.  ``PORT 0`` binds
an ephemeral port; ``--port-file`` publishes the bound port for scripted
clients (``python -m repro_torch.serving.client``).  ``--quality`` is then
the default for payloads that carry none.

``--mode lm`` serves the SMOKE variant of ``--arch`` (random weights from
``--seed``), as ``repro.launch.serve`` does: requests of ``--prompt-len``
random tokens, packed into batches of ``--batch`` (the last padded with
copies of its last request), each batch prefilled, its prompt written
into the KV cache by teacher-forced decode steps, then ``--gen-len``
tokens decoded greedily (:func:`greedy_generate`).  No kernel of
``repro_torch.kernels`` runs on this path, as no Pallas kernel runs on the
reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion --unet sd_v14 \\
      --requests 4 --batch 2 --timesteps 8 --cache cross --quality draft
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --engine static --pas
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --batch 4 --shards 2 \\
      --cache cross --timesteps 6
  PYTHONPATH=src python -m repro_torch.launch.serve --unet sd_v14 --batch 2 --timesteps 8 \\
      --cache cross --http 127.0.0.1:0 --port-file build/http.port
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch gemma3-1b --requests 4
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import signal
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.configs import ARCH_IDS, get_lm_config
from repro_torch.launch.steps import (
    ArchAdapter,
    get_adapter,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.models import unet as U
from repro_torch.serving import config as CFG
from repro_torch.serving.driver import EngineDriver
from repro_torch.serving.engine import (
    GenRequest, added_conditioning, serve_static, torch_device)
from repro_torch.serving.frontend import HTTPFrontend, RequestFactory
from repro_torch.serving.policy import QualityPolicy, default_pas_plan


# ---------------------------------------------------------------------------
# Request plumbing (lm mode; diffusion uses the engine's GenRequest)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    payload: Any  # token prompt
    submitted: float = dataclasses.field(default_factory=time.perf_counter)
    completed: float | None = None
    result: Any = None

    @property
    def latency(self) -> float:
        return (self.completed or time.perf_counter()) - self.submitted


def pack_batches(reqs: list[Request], batch: int) -> list[list[Request]]:
    """Fixed-size batches; the caller pads the tail batch by repeating its
    last request (results for pad lanes are dropped)."""
    return [reqs[i : i + batch] for i in range(0, len(reqs), batch)]


def make_lm_requests(args, vocab_size: int) -> list[Request]:
    """The reference's prompts: ``--requests`` rows of ``--prompt-len``
    tokens from ``np.random.default_rng(--seed)``."""
    rng = np.random.default_rng(args.seed)
    return [
        Request(rid=i,
                payload=rng.integers(0, vocab_size, size=(args.prompt_len,)).astype(np.int32))
        for i in range(args.requests)
    ]


def greedy_generate(
    adapter: ArchAdapter,
    params: Any,
    tokens: torch.Tensor,
    gen_len: int,
    step_hook: Callable[[int, torch.Tensor], None] | None = None,
) -> torch.Tensor:
    """Greedy continuation of ``tokens`` [B, P]: a prefill gives the first
    token, teacher-forced decode steps write the prompt into the KV cache,
    then ``gen_len - 1`` decode steps each take the argmax of the last
    (codebook 0 of a multi-codebook model).  Returns [B, gen_len] token ids.
    ``step_hook(pos, logits)`` sees every decode step's logits."""
    b, prompt_len = tokens.shape
    decode = make_decode_step(adapter)
    nxt = torch.argmax(make_prefill_step(adapter)(params, tokens), dim=-1)
    if nxt.ndim > 1:  # multi-codebook heads: greedy over codebook 0
        nxt = nxt[..., 0]
    cache = adapter.init_cache(b, prompt_len + gen_len, tokens.device)
    for pos in range(prompt_len):
        lg, cache = decode(params, cache, tokens[:, pos], pos)
        if step_hook is not None:
            step_hook(pos, lg)
    outs = [nxt]
    for i in range(gen_len - 1):
        lg, cache = decode(params, cache, nxt, prompt_len + i)
        if step_hook is not None:
            step_hook(prompt_len + i, lg)
        nxt = torch.argmax(lg, dim=-1)
        if nxt.ndim > 1:
            nxt = nxt[..., 0]
        outs.append(nxt)
    return torch.stack(outs, dim=1)


def serve_lm(args) -> dict:
    """Batched prefill + greedy decode of ``args.arch``'s SMOKE variant."""
    device = torch_device(args.device)
    cfg = get_lm_config(args.arch, "smoke")
    adapter = get_adapter(cfg)
    params = adapter.init(torch.Generator(device=device).manual_seed(args.seed), device)
    reqs = make_lm_requests(args, cfg.vocab_size)

    b = args.batch
    done: list[Request] = []
    t_start = time.perf_counter()
    for group in pack_batches(reqs, b):
        toks = np.stack([g.payload for g in group] + [group[-1].payload] * (b - len(group)))
        gen = greedy_generate(adapter, params, torch.from_numpy(toks).to(device), args.gen_len)
        gen = gen.cpu().numpy()
        now = time.perf_counter()
        for lane, g in enumerate(group):
            g.result = gen[lane]
            g.completed = now
            done.append(g)
    wall = time.perf_counter() - t_start

    lat = [r.latency for r in done]
    total_tokens = len(done) * args.gen_len
    return {
        "mode": "lm",
        "arch": args.arch,
        "requests": len(done),
        "wall_s": round(wall, 3),
        "tok_s": round(total_tokens / wall, 1),
        "p50_latency_s": round(float(np.percentile(lat, 50)), 3),
        "gen_shape": tuple(done[0].result.shape),
    }


# ---------------------------------------------------------------------------
# Diffusion serving
# ---------------------------------------------------------------------------


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
                **added_conditioning(ucfg, rng),
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
        if getattr(args, "shards", 1) > 1:
            raise SystemExit(
                "--shards requires the continuous engine (lockstep batches have "
                "no lane axis to shard); drop --engine static or --shards"
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


def _parse_hostport(value: str) -> tuple[str, int]:
    host, _, port = value.rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise SystemExit(f"--http wants HOST:PORT (PORT 0 = ephemeral), got {value!r}")


def serve_http(args) -> None:
    """Run the async HTTP frontend until a graceful drain completes; exits
    non-zero unless the drain was clean."""
    if getattr(args, "engine", "continuous") == "static":
        raise SystemExit(
            "--http requires the continuous engine (the lockstep baseline has "
            "no event loop to drive asynchronously); drop --engine static"
        )
    host, port = _parse_hostport(args.http)
    cfg = CFG.from_args(args, decode_images=False)
    bundle = CFG.build_engine(cfg)  # no GPU and no --device cpu: raises before binding
    K.reset_launch_counts()  # the drained line reports the launches of serving alone
    driver = EngineDriver(bundle.engine, max_inflight=cfg.max_inflight)
    factory = RequestFactory(
        bundle.ucfg, bundle.dcfg, cfg, policy=bundle.policy, default_quality=cfg.quality,
    )

    async def amain() -> dict:
        driver.start()
        frontend = HTTPFrontend(driver, factory, host, port)
        await frontend.start()
        print(f"[serve] http listening on {frontend.host}:{frontend.port}", flush=True)
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(frontend.port))
            os.replace(tmp, args.port_file)  # atomic: clients never see a partial write
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, frontend.request_shutdown)
        return await frontend.serve_until_shutdown()

    summary = asyncio.run(amain())
    # the warm-slot key table stays on /stats and /cache/keys: at sd_v14 it
    # holds 768 floats a slot
    shown = {k: v for k, v in summary.items() if k != "cache_slots_summary"}
    shown["launches"] = K.launch_counts()
    print(f"[serve] drained {shown}", flush=True)
    if not summary.get("drained", False):
        raise SystemExit("server stopped without a clean drain")


def build_parser() -> argparse.ArgumentParser:
    """The serving CLI's flags (``CFG.from_args`` maps them to an engine config)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["diffusion", "lm"], default="diffusion")
    ap.add_argument("--unet", default="sd_toy")
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b",
                    help="LM arch (--mode lm; its SMOKE variant is served)")
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
        "--shards", type=int, default=1,
        help="lane shards, shard d on card d (continuous engine only; needs >= N "
        "visible cards, or --device cpu, where every shard is on the CPU)",
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
    ap.add_argument(
        "--cache-gossip", dest="cache_gossip", action="store_true", default=True,
        help="admit a warm request to the shard whose ring holds its slots "
        "(sharded engine; default on)",
    )
    ap.add_argument(
        "--no-cache-gossip", dest="cache_gossip", action="store_false",
        help="admit to the emptiest shard only",
    )
    ap.add_argument(
        "--http", metavar="HOST:PORT", default=None,
        help="serve the continuous engine over the asyncio HTTP frontend (PORT 0 = "
        "ephemeral) instead of running a synthetic batch; drains on SIGINT/SIGTERM "
        "or POST /shutdown",
    )
    ap.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="write the bound HTTP port here (atomically) once listening",
    )
    ap.add_argument(
        "--max-inflight", type=int, default=32,
        help="bounded admission depth of the HTTP frontend (429 beyond it)",
    )
    ap.add_argument("--prompt-len", type=int, default=16, help="prompt tokens (--mode lm)")
    ap.add_argument("--gen-len", type=int, default=16, help="generated tokens (--mode lm)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.http is not None:
        if args.mode != "diffusion":
            raise SystemExit("--http currently serves --mode diffusion only")
        serve_http(args)
        return
    stats = serve_diffusion(args) if args.mode == "diffusion" else serve_lm(args)
    print(f"[serve] {stats}")


if __name__ == "__main__":
    main()
