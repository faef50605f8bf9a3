#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Drives the port's main path, ``repro_torch.serving.config.build_engine`` ->
``DiffusionEngine.run``, at the full width of ``sd_v14`` (random weights
from a seed) and holds each hand-written kernel against its plain PyTorch
version.  Phases:

1. the card's name and power limit; TF32 off for every float32 product;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels against plain: log every distinct shape the ``cuda`` backend
   sees in one FULL micro-step, one SKETCH micro-step and one VAE decode;
   at each, compare kernel and plain version on the card and time kernel,
   plain version and one PyTorch library call on the device alone, with
   the calls queued behind a spin so no host gap enters (``F.conv2d``,
   ``F.group_norm`` + ``F.silu``, ``F.scaled_dot_product_attention``, used as
   yardsticks only); check flash attention's causal/window/softcap/GQA
   options at one small shape;
4. registry kernels: drive ``stream_norm`` and ``fused_matmul``, which no
   served path runs, through ``repro_torch.kernels.KERNEL_REGISTRY`` at
   sd_v14's full-width shapes (counting their launches), then hold each
   result against the plain version and time kernel, plain version and one
   PyTorch library call (``F.layer_norm`` / ``F.rms_norm``; ``torch.mm`` /
   ``torch.addmm`` with the activation as a second call);
5. serve 4 requests (two phase-aware, two all-FULL) through the engine with
   the ``cuda`` backend, counting kernel launches, then the same stream with
   the ``eager`` backend, and compare the latents.

Run from the repository root: ``python3 chip_smoke.py``.  It prints the
per-kernel JSON line, the card line and, last, the ``{"ok": true, ...}``
line; any failed phase exits non-zero.  Details go to
``chiprun_out/chip_smoke_detail.json``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 without
#: tensor cores, bfloat16 dense on tensor cores
MEM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
#: kernel-vs-plain tolerance, relative to max(1, max |plain|): float32 sums in
#: another order (conv over up to 9*2560 terms, group norm over up to 262144)
TOL = {"uniconv": 2e-5, "stream_group_norm": 2e-5, "flash_attention": 1e-4}
#: cuda-vs-eager engine latents, relative to max(1, max |eager latent|): eight
#: guided PNDM steps amplify the per-op float32 differences (measured 1e-5
#: relative on an H100)
SERVE_TOL = 1e-4
UNET, N_LANES, MAX_STEPS = "sd_v14", 2, 8
SOURCES = {
    "uniconv": (
        "src/repro_torch/kernels/csrc/uniconv.cu", "src/repro/kernels/uniconv/kernel.py:78",
    ),
    "stream_group_norm": (
        "src/repro_torch/kernels/csrc/group_norm.cu", "src/repro/kernels/stream_norm/kernel.py:91",
    ),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:90",
    ),
}
#: the kernels no served path runs, reached through KERNEL_REGISTRY (phase 4)
REGISTRY_SOURCES = {
    "stream_norm": (
        "src/repro_torch/kernels/csrc/stream_norm.cu", "src/repro/kernels/stream_norm/kernel.py:44",
    ),
    "fused_matmul": (
        "src/repro_torch/kernels/csrc/fused_matmul.cu",
        "src/repro/kernels/fused_matmul/kernel.py:80",
    ),
}
#: phase 4 shapes: where sd_v14's U-Net computes the same function outside
#: Pallas, at CFG batch 4 (2 lanes; 16384 / 4096 / 1024 tokens at levels 0-2).
#: stream_norm: (label, M, D, mode, eps, dtype); rmsnorm is passed a bias,
#: which it ignores
NORM_CASES = [
    ("ln level 0", 16384, 320, "layernorm", 1e-5, "float32"),
    ("ln level 1", 4096, 640, "layernorm", 1e-5, "float32"),
    ("ln level 2", 1024, 1280, "layernorm", 1e-5, "float32"),
    ("rms level 0", 16384, 320, "rmsnorm", 1e-5, "float32"),
    ("rms level 1", 4096, 640, "rmsnorm", 1e-5, "float32"),
    ("rms level 2", 1024, 1280, "rmsnorm", 1e-5, "float32"),
    ("ln level 0 bf16", 16384, 320, "layernorm", 1e-5, "bfloat16"),
    ("ragged", 100, 33, "layernorm", 1e-6, "float32"),
]
#: fused_matmul: (label, M, K, N, epilogue, with_stats, dtype)
MATMUL_CASES = [
    ("ff_in", 16384, 320, 2560, "none", False, "float32"),
    ("ff_out", 16384, 1280, 320, "none", False, "float32"),
    ("self_o + ln2 stats", 16384, 320, 320, "none", True, "float32"),
    ("GEGLU gate half", 16384, 320, 1280, "gelu", False, "float32"),
    ("time MLP w1", 4, 320, 1280, "silu", False, "float32"),
    ("GEGLU gate half bf16", 16384, 320, 1280, "gelu", False, "bfloat16"),
    ("ragged", 96, 160, 224, "bias", True, "float32"),
]
#: phase 4 tolerances, relative to max(1, max |plain|): float32 sums in another
#: order (norm rows of up to 1280, products over K <= 1280); a bfloat16 output
#: may differ by one bfloat16 step (2**-7 of the value) where the float32
#: sums round to either side.  Stats: rtol / atol, as the JAX package's test.
REG_TOL = {"stream_norm": 2e-5, "fused_matmul": 1e-4, "bfloat16": 2.0**-7}
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3


def _phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[chip_smoke] phase {name}: {now - t0:.1f} s", flush=True)
    return now


def _ms(torch, fn, reps: int = 5, queued: bool = True) -> float:
    """Mean ms of ``reps`` back-to-back calls of ``fn`` between two CUDA events.

    With ``queued`` the card first spins (``torch.cuda._sleep``) for longer
    than the host takes to enqueue every call, so the events time the device
    work alone and not the host's launch overhead, which would otherwise set
    the time of a kernel of a few microseconds."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        torch.cuda._sleep(int((reps * host_s + 1e-3) * 2e9))  # cycles: that long at <= 2 GHz
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


class ShapeLog:
    """A ``cuda`` KernelBackend that records each call's shapes, then runs it."""

    def __init__(self, KB, cuda):
        self.phase = ""
        #: phase -> call shape -> number of calls
        self.by_phase: dict[str, dict[tuple, int]] = {}

        def log(key):
            counts = self.by_phase.setdefault(self.phase, {})
            counts[key] = counts.get(key, 0) + 1

        def conv(w, b, x, hw, ksize, stride=1):
            log(("uniconv", tuple(x.shape), tuple(w.shape), tuple(hw), ksize, stride))
            return cuda.conv(w, b, x, hw, ksize, stride)

        def group_norm(x, p, groups, *, eps=1e-5, silu=False):
            log(("stream_group_norm", tuple(x.shape), groups, bool(silu)))
            return cuda.group_norm(x, p, groups, eps=eps, silu=silu)

        def attention(q, k, v, o_proj, n_heads):
            b, lq, c = q.shape
            dh = c // n_heads
            log(("flash_attention", (b, n_heads, lq, dh), (b, n_heads, k.shape[1], dh)))
            return cuda.attention(q, k, v, o_proj, n_heads)

        self.backend = KB("cuda", conv, group_norm, attention)

    @property
    def calls(self) -> dict[tuple, int]:
        out: dict[tuple, int] = {}
        for counts in self.by_phase.values():
            for key, n in counts.items():
                out[key] = out.get(key, 0) + n
        return out


def _check_shape(torch, F, ops, key, gen):
    """Kernel vs plain at one logged shape ->
    (err, tol_abs, ms, plain_ms, library_ms, bytes_ms, ops_ms)."""
    dev = "cuda"
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    kind = key[0]
    if kind == "uniconv":
        _, xs, ws, hw, k, stride = key
        x, w, bias = r(*xs), r(*ws) * (ws[0] * ws[1]) ** -0.5, r(ws[2])
        kern = lambda: ops["uniconv"](x, w, bias, hw, k, stride)  # noqa: E731
        plain = lambda: ops["uniconv_apply"](w, bias, x, hw, k, stride)  # noqa: E731
        x4 = x.reshape(xs[0], hw[0], hw[1], xs[2]).permute(0, 3, 1, 2).contiguous()
        w4 = w.reshape(k, k, ws[1], ws[2]).permute(3, 2, 0, 1).contiguous()
        lib = lambda: F.conv2d(x4, w4, bias, stride=stride, padding=(k - 1) // 2)  # noqa: E731
        out_n = xs[0] * (-(-hw[0] // stride)) * (-(-hw[1] // stride)) * ws[2]
        nbytes = 4 * (x.numel() + w.numel() + bias.numel() + out_n)
        flops = 2 * out_n * ws[0] * ws[1]
    elif kind == "stream_group_norm":
        _, xs, groups, silu = key
        x, sc, bi = r(*xs) + 0.5, r(xs[2]), r(xs[2])
        kern = lambda: ops["stream_group_norm"](x, sc, bi, groups=groups, silu=silu)  # noqa: E731
        plain = lambda: ops["stream_group_norm_plain"](  # noqa: E731
            x, sc, bi, groups=groups, silu=silu
        )
        xc = x.transpose(1, 2).contiguous()

        def lib():
            y = F.group_norm(xc, groups, sc, bi, eps=1e-5)
            return F.silu(y) if silu else y

        nbytes = 4 * (2 * x.numel() + 2 * xs[2])
        flops = x.numel() * (8 + (4 if silu else 0))
    else:
        _, qs, ks = key
        q, k, v = r(*qs), r(*ks), r(*ks)
        kern = lambda: ops["flash_attention"](q, k, v, causal=False)  # noqa: E731
        plain = lambda: ops["flash_attention_ref"](q, k, v, causal=False)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        flops = 4 * qs[0] * qs[1] * qs[2] * ks[2] * qs[3]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tol = TOL[kind] * max(1.0, float(ref.abs().max()))
    del got, ref
    return (
        err, tol, _ms(torch, kern), _ms(torch, plain), _ms(torch, lib),
        nbytes / MEM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3,
    )


def _registry_inputs(torch, gen, name, case):
    """(args, kwargs, library call) of one phase-4 case."""
    F = torch.nn.functional
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    if name == "stream_norm":
        _, m, d, mode, eps, dt = case
        dtype = getattr(torch, dt)
        x, sc, bi = (r(m, d) * 2 + 0.5).to(dtype), r(d) * 0.1 + 1, r(d) * 0.1
        sc_l, bi_l = sc.to(dtype), bi.to(dtype)
        if mode == "layernorm":
            lib = lambda: F.layer_norm(x, (d,), sc_l, bi_l, eps)  # noqa: E731
        else:
            lib = lambda: F.rms_norm(x, (d,), sc_l, eps)  # noqa: E731
        return (x, sc, bi), dict(mode=mode, eps=eps), lib
    _, m, k, n, epilogue, with_stats, dt = case
    dtype = getattr(torch, dt)
    a, b, bias = r(m, k).to(dtype), (r(k, n) * k**-0.5).to(dtype), r(n).to(dtype)
    act = {"gelu": F.gelu, "silu": F.silu}.get(epilogue)  # F.gelu is the erf form
    if epilogue == "none":
        lib = lambda: torch.mm(a, b)  # noqa: E731
    elif act is None:
        lib = lambda: torch.addmm(bias, a, b)  # noqa: E731
    else:
        lib = lambda: act(torch.addmm(bias, a, b))  # noqa: E731
    return (a, b, bias), dict(epilogue=epilogue, with_stats=with_stats), lib


def _registry_cost(name, case):
    """(bytes_ms, ops_ms) of one phase-4 case: each input read once, each
    output written once, against the peak rate of the operands' type."""
    if name == "stream_norm":
        _, m, d, _, _, dt = case
        size = 2 if dt == "bfloat16" else 4
        return (2 * m * d * size + 2 * d * 4) / MEM_BYTES_S * 1e3, 8 * m * d / FP32_FLOP_S * 1e3
    _, m, k, n, epilogue, with_stats, dt = case
    size, rate = (2, BF16_FLOP_S) if dt == "bfloat16" else (4, FP32_FLOP_S)
    nbytes = (m * k + k * n + m * n) * size + (n * 4 if epilogue != "none" else 0)
    nbytes += 8 * m if with_stats else 0
    return nbytes / MEM_BYTES_S * 1e3, 2 * m * n * k / rate * 1e3


def _registry_phase(torch, K, gen):
    """Drive the registry kernels once (counted), then check and time them.
    Returns (per-kernel totals, rows, failures)."""
    cases = [("stream_norm", c) for c in NORM_CASES] + [("fused_matmul", c) for c in MATMUL_CASES]
    inputs = [_registry_inputs(torch, gen, name, case) for name, case in cases]
    K.reset_launch_counts()
    with torch.no_grad():
        outs = [K.KERNEL_REGISTRY[name][0](*args, **kw)
                for (name, _), (args, kw, _) in zip(cases, inputs)]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    failures = [f"{name} was never launched through KERNEL_REGISTRY"
                for name in REGISTRY_SOURCES if launches[name] <= 0]
    totals = {name: dict(launches=launches[name], err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                         bytes_ms=0.0, ops_ms=0.0) for name in REGISTRY_SOURCES}
    rows = []
    with torch.no_grad():
        for (name, case), (args, kw, lib), got in zip(cases, inputs, outs):
            kern, plain = K.KERNEL_REGISTRY[name]
            ref = plain(*args, **kw)
            stats_err = None
            if name == "fused_matmul":
                (got, stats), (ref, ref_stats) = got, ref
                if stats is not None:
                    diff = (stats - ref_stats).abs()
                    stats_err = float(diff.max())
                    if bool((diff > STATS_ATOL + STATS_RTOL * ref_stats.abs()).any()):
                        failures.append(f"{name} {case[0]}: stats differ by {stats_err}")
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            rel = REG_TOL["bfloat16" if got.dtype == torch.bfloat16 else name]
            tol = rel * max(1.0, float(ref.float().abs().max()))
            del got, ref
            if not err <= tol:
                failures.append(f"{name} {case[0]}: max |kernel - plain| {err} > {tol}")
            ms = _ms(torch, lambda: kern(*args, **kw))
            pms = _ms(torch, lambda: plain(*args, **kw))
            lms = _ms(torch, lib)
            bytes_ms, ops_ms = _registry_cost(name, case)
            row = dict(kernel=name, case=list(case), max_abs_err=err, tol=tol,
                       stats_err=stats_err, ms=ms, plain_ms=pms, library_ms=lms,
                       bytes_ms=bytes_ms, ops_ms=ops_ms)
            rows.append(row)
            tot = totals[name]
            tot["err"] = max(tot["err"], err)
            for f in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"):
                tot[f] += row[f]
            print(f"[chip_smoke]   {name} {case}: err {err:.3g} (tol {tol:.3g})"
                  + ("" if stats_err is None else f" stats err {stats_err:.3g}")
                  + f" kernel {ms:.4f} ms plain {pms:.4f} ms library {lms:.4f} ms"
                  f" bound {max(bytes_ms, ops_ms):.4f} ms")
    for name, v in totals.items():
        print(f"[chip_smoke]   {name}: {v['launches']} launches, kernel {v['ms']:.3f} ms, "
              f"plain {v['plain_ms']:.3f} ms, library {v['library_ms']:.3f} ms, bound "
              f"{max(v['bytes_ms'], v['ops_ms']):.3f} ms")
    return totals, rows, failures


def _kernel_entry(name, src, rep, launches, tot) -> dict:
    return dict(
        name=name, route="cuda", source=src, replaces=rep, launches=launches,
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=max(tot["bytes_ms"], tot["ops_ms"]),
        bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        library_ms=tot["library_ms"],
    )


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.core import sampler as SM
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
    from repro_torch.kernels.stream_norm.ops import stream_group_norm, stream_group_norm_plain
    from repro_torch.kernels.uniconv.ops import uniconv, uniconv_apply
    from repro_torch.models import unet as U
    from repro_torch.models import vae as V
    from repro_torch.models.backend import CUDA, EAGER, KernelBackend
    from repro_torch.serving import config as CFG
    from repro_torch.serving.engine import EngineConfig, GenRequest
    from repro_torch.serving.policy import default_pas_plan

    ops = dict(
        uniconv=uniconv, uniconv_apply=uniconv_apply, stream_group_norm=stream_group_norm,
        stream_group_norm_plain=stream_group_norm_plain, flash_attention=flash_attention,
        flash_attention_ref=flash_attention_ref,
    )
    detail: dict = {}
    t0 = t_start = time.perf_counter()

    # 1. the card ---------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[chip_smoke] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = _phase("card", t0)

    # 2. build ------------------------------------------------------------------
    secs = build.build_all()
    print(f"[chip_smoke] kernels built in {secs:.1f} s into {build.BUILD_DIR}")
    for name, log in build.BUILD_LOG.items():
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[chip_smoke]   {name}.cu: {regs}")
    t0 = _phase("build", t0)

    # 3. kernels against plain at every served shape ------------------------------
    config = EngineConfig(
        n_lanes=N_LANES, max_steps=MAX_STEPS, l_sketch=3, l_refine=2, decode_images=True,
        backend="cuda", device="cuda", unet=UNET, seed=0,
    )
    models = CFG.init_models(config)
    ucfg, dcfg, params, vae_params = models
    n_up = U.n_up_steps(ucfg)
    e_sk = n_up - config.l_sketch
    log = ShapeLog(KernelBackend, CUDA)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((N_LANES, ucfg.latent_size**2, ucfg.in_channels), generator=gen, device="cuda")
    t = torch.tensor([981, 861], device="cuda")
    ctx2 = torch.randn((2 * N_LANES, ucfg.ctx_len, ucfg.ctx_dim), generator=gen, device="cuda")
    lhw = (ucfg.latent_size, ucfg.latent_size)
    with torch.no_grad():
        _, cap = SM.cfg_unet_step(ucfg, params, 7.5, x, t, ctx2, capture=(e_sk,), backend=CUDA)
        feat = cap[e_sk]
        del cap
        batch = f"({N_LANES} lanes, CFG batch {2 * N_LANES})"
        passes = {
            f"FULL micro-step {batch}": lambda bk: SM.cfg_unet_step(
                ucfg, params, 7.5, x, t, ctx2, capture=(e_sk,), backend=bk),
            f"SKETCH micro-step {batch}": lambda bk: SM.cfg_unet_step(
                ucfg, params, 7.5, x, t, ctx2, entry_step=e_sk, entry_feat=feat, backend=bk),
            "VAE decode (one image)": lambda bk: V.vae_decode(vae_params, x[:1], lhw, backend=bk),
        }
        pass_ms = {}
        for phase, run in passes.items():
            log.phase = phase
            run(log.backend)
            pass_ms[phase] = {
                name: _ms(torch, lambda: run(bk), reps=3, queued=False)
                for name, bk in (("cuda", CUDA), ("eager", EAGER))
            }
        del feat
    torch.cuda.synchronize()
    detail["pass_ms"] = pass_ms
    rows, failures, by_key = [], [], {}
    with torch.no_grad():
        for key, n in sorted(log.calls.items(), key=lambda kv: str(kv[0])):
            err, tol, ms, pms, lms, bytes_ms, ops_ms = _check_shape(torch, F, ops, key, gen)
            row = dict(key=list(key), calls=n, max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                       library_ms=lms, bytes_ms=bytes_ms, ops_ms=ops_ms)
            rows.append(row)
            by_key[key] = row
            print(f"[chip_smoke]   {key} x{n}: err {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms "
                  f"plain {pms:.4f} ms library {lms:.4f} ms bound {max(bytes_ms, ops_ms):.4f} ms")
            if not err <= tol:
                failures.append(f"{key}: max |kernel - plain| {err} > {tol}")
        # the options the served path does not use, at one small shape
        q = torch.randn((2, 4, 200, 40), generator=gen, device="cuda")
        kv = torch.randn((2, 2, 200, 40), generator=gen, device="cuda")
        for opts in (
            dict(causal=True), dict(causal=True, window=37), dict(causal=False, softcap=5.0)
        ):
            got, ref = flash_attention(q, kv, kv, **opts), flash_attention_ref(q, kv, kv, **opts)
            err = float((got - ref).abs().max())
            print(f"[chip_smoke]   flash_attention GQA 4/2 {opts}: err {err:.3g}")
            if not err <= TOL["flash_attention"]:
                failures.append(f"flash_attention {opts}: {err}")
    detail["shapes"] = rows

    def summed(counts: dict[tuple, int]) -> dict[str, dict]:
        """Per kernel, over ``counts`` calls: launches, max error, and each
        time and bound summed with the number of calls at each shape."""
        out = {name: dict(launches=0, err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                          bytes_ms=0.0, ops_ms=0.0) for name in SOURCES}
        for key, n in counts.items():
            tot, row = out[key[0]], by_key[key]
            tot["launches"] += n
            tot["err"] = max(tot["err"], row["max_abs_err"])
            for f in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"):
                tot[f] += n * row[f]
        return out

    for phase, counts in log.by_phase.items():
        per = summed(counts)
        print(f"[chip_smoke] {phase}: U-Net/decoder pass cuda {pass_ms[phase]['cuda']:.2f} ms, "
              f"eager {pass_ms[phase]['eager']:.2f} ms")
        for name, v in per.items():
            print(f"[chip_smoke]   {name}: {v['launches']} launches, kernel {v['ms']:.2f} ms, "
                  f"plain {v['plain_ms']:.2f} ms, library {v['library_ms']:.2f} ms, bound "
                  f"{max(v['bytes_ms'], v['ops_ms']):.2f} ms")
        detail.setdefault("per_pass", {})[phase] = per
    # the JSON line's times: one FULL and one SKETCH micro-step and one decode
    totals = summed(log.calls)
    if failures:
        raise AssertionError("kernel disagrees with its plain version:\n" + "\n".join(failures))
    t0 = _phase("kernels against plain", t0)

    # 4. the registry kernels off the served path -----------------------------------
    reg_totals, reg_rows, reg_failures = _registry_phase(torch, K, gen)
    detail["registry"] = reg_rows
    if reg_failures:
        raise AssertionError("registry kernels:\n" + "\n".join(reg_failures))
    t0 = _phase("registry kernels", t0)

    # 5. serve --------------------------------------------------------------------
    def requests():
        out = []
        for i in range(4):
            rng = np.random.default_rng(100_003 * 7 + i)
            out.append(GenRequest(
                rid=i,
                ctx=rng.normal(size=(ucfg.ctx_len, ucfg.ctx_dim)).astype(np.float32),
                noise=rng.normal(size=(ucfg.latent_size**2, ucfg.in_channels)).astype(np.float32),
                timesteps=MAX_STEPS,
                plan=default_pas_plan(MAX_STEPS, n_up) if i % 2 == 0 else None,
            ))
        return out

    results = {}
    for backend in ("cuda", "eager"):
        cfg = dataclasses.replace(config, backend=backend)
        engine = CFG.build_engine(cfg, models=models).engine
        K.reset_launch_counts()
        with torch.no_grad():
            done, summary = engine.run(requests())
        torch.cuda.synchronize()
        launches = K.launch_counts()
        results[backend] = ({d.rid: d for d in done}, summary, launches)
        print(f"[chip_smoke] serve {backend}: {summary}")
        print(f"[chip_smoke]   launches: {launches}")
        if sorted(d.rid for d in done) != [0, 1, 2, 3]:
            raise AssertionError(f"{backend}: completed rids {sorted(d.rid for d in done)}")
        for d in done:
            if d.image.shape != (16 * ucfg.latent_size**2, 3):
                raise AssertionError(f"{backend}: image shape {d.image.shape}")
            if not (np.isfinite(d.latent).all() and np.isfinite(d.image).all()):
                raise AssertionError(f"{backend}: rid {d.rid} is not finite")
        t0 = _phase(f"serve {backend}", t0)
    done_c, summary_c, launches = results["cuda"]
    done_e, summary_e, _ = results["eager"]
    if any(launches[name] <= 0 for name in SOURCES):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    scale = max(1.0, max(float(np.abs(d.latent).max()) for d in done_e.values()))
    serve_err = max(float(np.abs(done_c[r].latent - done_e[r].latent).max()) for r in done_e)
    image_err = max(float(np.abs(done_c[r].image - done_e[r].image).max()) for r in done_e)
    print(f"[chip_smoke] latents cuda vs eager: max |d| {serve_err:.3g} on max |latent| "
          f"{scale:.3g} (tol {SERVE_TOL * scale:.3g}); images max |d| {image_err:.3g}")
    detail["serve"] = dict(cuda=summary_c, eager=summary_e, launches=launches,
                           latent_err=serve_err, latent_scale=scale, image_err=image_err)
    if not serve_err <= SERVE_TOL * scale:
        raise AssertionError(f"cuda latents differ from eager by {serve_err}")

    kernels = [
        _kernel_entry(name, src, rep, launches[name], totals[name])
        for name, (src, rep) in SOURCES.items()
    ] + [
        _kernel_entry(name, src, rep, reg_totals[name]["launches"], reg_totals[name])
        for name, (src, rep) in REGISTRY_SOURCES.items()
    ]
    detail.update(card=card, kernels=kernels, seconds=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_detail.json").write_text(json.dumps(detail, indent=1, default=str))
    _phase("total", t_start)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
