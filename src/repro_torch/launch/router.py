"""Replica-router CLI of the PyTorch port: the multi-process front door.

Port of ``repro/launch/router.py``.  Spawns ``--replicas N`` independent
serving processes (each a full ``repro_torch.launch.serve --http`` engine
stack on its own loopback port) and runs a
:class:`repro_torch.serving.router.ReplicaRouter` gateway over them:
health-checked supervision with eviction + exponential-backoff respawn,
least-loaded admission refined by published cache warmth, transparent
failover for accepted requests, and a rolling one-replica-at-a-time drain
on SIGINT/SIGTERM or ``POST /shutdown``.

The router process itself never imports torch (engines live only in the
replica subprocesses), so the gateway stays responsive while replicas
build, crash or restart.

Every replica is started with the **same** engine flags, including
``--seed``: identical weights plus the frontend's deterministic request
synthesis mean a request that fails over mid-crash reproduces the exact
``latent_digest`` it would have produced on the original replica.
Replicas run on the GPU (``--device cuda``, several processes sharing the
card) unless ``--device cpu`` is passed; a replica that exits during
start-up stops the router, which prints the tail of that replica's log
and exits non-zero.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.router --replicas 2 \\
      --http 127.0.0.1:0 --port-file build/router.port --run-dir build/router \\
      --unet sd_v14 --batch 2 --timesteps 8 --cache cross

  # then point any client at the router as if it were a single server:
  PYTHONPATH=src python -m repro_torch.serving.client --port-file build/router.port \\
      --requests 8 --task mix --router --shutdown

Exits 0 only after a clean rolling drain (every replica exited 0 and no
proxied stream was lost).
"""
from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys
import tempfile

from repro_torch.serving.router import ReplicaHandle, ReplicaRouter

#: bytes of a failed replica's log printed when the fleet cannot start
LOG_TAIL_BYTES = 4000


def _parse_hostport(value: str) -> tuple[str, int]:
    host, _, port = value.rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise SystemExit(f"--http wants HOST:PORT (PORT 0 = ephemeral), got {value!r}")


def replica_command(args) -> list[str]:
    """The serve invocation every replica runs (``--port-file`` is appended
    per generation by :class:`ReplicaHandle`)."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.serve",
        "--mode", "diffusion",
        "--http", "127.0.0.1:0",
        "--device", args.device,
        "--unet", args.unet,
        "--batch", str(args.batch),
        "--timesteps", str(args.timesteps),
        "--window", str(args.window),
        "--max-inflight", str(args.max_inflight),
        "--cache", args.cache,
        "--cache-threshold", str(args.cache_threshold),
        "--cache-slots", str(args.cache_slots),
        "--cache-bucket", str(args.cache_bucket),
        "--cache-spill-mb", str(args.cache_spill_mb),
        "--seed", str(args.seed),  # same weights on every replica: failover
                                   # reproduces the original latent_digest
    ]
    if args.kernels is not None:
        cmd += ["--kernels", args.kernels]
    if args.pas:
        cmd.append("--pas")
    if args.quality is not None:
        cmd += ["--quality", args.quality]
    if args.profile is not None:
        cmd += ["--profile", args.profile]
    if not args.cache_gossip:
        cmd.append("--no-cache-gossip")
    if args.shards > 1:
        cmd += ["--shards", str(args.shards)]
    return cmd


def _log_tail(h: ReplicaHandle) -> str:
    try:
        with open(h.log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - LOG_TAIL_BYTES))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=2, help="server replicas to spawn")
    ap.add_argument(
        "--http", metavar="HOST:PORT", default="127.0.0.1:0",
        help="router bind address (PORT 0 = ephemeral)",
    )
    ap.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="write the router's bound port here (atomically) once listening",
    )
    ap.add_argument(
        "--run-dir", default=None, metavar="DIR",
        help="replica port files + logs land here (default: a fresh tempdir)",
    )
    # engine flags forwarded verbatim to every replica
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of every replica; the GPU unless 'cpu' is asked for",
    )
    ap.add_argument("--unet", default="sd_toy")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--timesteps", type=int, default=20)
    ap.add_argument("--pas", action="store_true")
    ap.add_argument("--quality", default=None, metavar="TIER|Q")
    ap.add_argument("--profile", default=None, metavar="PATH")
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument(
        "--kernels", choices=["eager", "cuda"], default=None,
        help="kernel backend of every replica (default: cuda on a GPU, eager on the CPU)",
    )
    ap.add_argument("--shards", type=int, default=1, help="lane shards per replica")
    ap.add_argument("--cache", choices=["off", "intra", "cross"], default="off")
    ap.add_argument("--cache-threshold", type=float, default=0.15)
    ap.add_argument("--cache-slots", type=int, default=16)
    ap.add_argument("--cache-bucket", type=int, default=125)
    ap.add_argument(
        "--cache-spill-mb", type=float, default=0.0,
        help="per-replica host-RAM spill ring budget in MiB (0 = off)",
    )
    ap.add_argument(
        "--cache-gossip", dest="cache_gossip", action="store_true", default=True,
        help="per-replica warm-shard admission (sharded replicas; default on)",
    )
    ap.add_argument(
        "--no-cache-gossip", dest="cache_gossip", action="store_false",
        help="every replica admits to its emptiest shard only",
    )
    ap.add_argument("--max-inflight", type=int, default=32, help="per replica")
    ap.add_argument("--seed", type=int, default=0)
    # router knobs
    ap.add_argument(
        "--warmth-weight", type=float, default=1.0,
        help="cache-warmth weight in routing scores (0 = pure least-loaded)",
    )
    ap.add_argument(
        "--health-interval", type=float, default=0.5,
        help="seconds between /healthz supervision probes",
    )
    ap.add_argument(
        "--fail-threshold", type=int, default=3,
        help="consecutive failed probes before a replica is evicted",
    )
    ap.add_argument("--probe-timeout", type=float, default=10.0)
    ap.add_argument(
        "--max-attempts", type=int, default=8,
        help="replica attempts per request before it errors out",
    )
    ap.add_argument(
        "--drain-timeout", type=float, default=300.0,
        help="per-replica graceful drain budget before SIGKILL",
    )
    ap.add_argument(
        "--spawn-timeout", type=float, default=300.0,
        help="per-replica startup budget (engine build and weights)",
    )
    ap.add_argument(
        "--no-respawn", action="store_true",
        help="evict crashed replicas without respawning them (tests)",
    )
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")

    host, port = _parse_hostport(args.http)
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="sdacc-router-")
    os.makedirs(run_dir, exist_ok=True)
    cmd = replica_command(args)
    replicas = [
        ReplicaHandle(i, cmd, run_dir, spawn_timeout_s=args.spawn_timeout)
        for i in range(args.replicas)
    ]
    router = ReplicaRouter(
        replicas, host, port,
        warmth_weight=args.warmth_weight,
        health_interval_s=args.health_interval,
        fail_threshold=args.fail_threshold,
        probe_timeout_s=args.probe_timeout,
        max_attempts=args.max_attempts,
        drain_timeout_s=args.drain_timeout,
        respawn=not args.no_respawn,
    )

    async def amain() -> dict:
        print(
            f"[router] spawning {args.replicas} replicas on {args.device} "
            f"(run dir {run_dir})",
            flush=True,
        )
        try:
            await router.start()
        except (RuntimeError, TimeoutError, ConnectionError, OSError):
            # a replica could not start (no GPU, a build failure, ...): name
            # its failure; the router never falls back to another device
            for h in replicas:
                # the ones start() killed after the first failure say nothing
                if h.proc is not None and h.proc.poll() not in (None, -signal.SIGKILL):
                    print(f"[router] replica {h.idx} exited with code "
                          f"{h.proc.returncode}; the tail of {h.log_path}:\n{_log_tail(h)}",
                          file=sys.stderr, flush=True)
            raise
        for h in replicas:
            print(f"[router] replica {h.idx} ready on 127.0.0.1:{h.port}", flush=True)
        print(f"[router] listening on {router.host}:{router.port}", flush=True)
        if args.port_file:
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(router.port))
            os.replace(tmp, args.port_file)  # atomic: clients never see a partial write
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, router.request_shutdown)
        return await router.serve_until_shutdown()

    try:
        summary = asyncio.run(amain())
    except BaseException:
        router.kill_all()  # never leak replica processes on a failed startup
        raise
    print(f"[router] drained {summary}", flush=True)
    if not summary.get("drained", False):
        raise SystemExit("router stopped without a clean drain")


if __name__ == "__main__":
    main()
