#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Drives the port's main path, ``repro_torch.serving.config.build_engine`` ->
``DiffusionEngine.run``, at the full width of ``sd_v14`` (random weights
from a seed) and holds each hand-written kernel against its plain PyTorch
version.  Phases:

1. the card's name and power limit; TF32 off for every float32 product
   (the library yardsticks; the kernels' own 3xTF32 products keep float32
   accuracy);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and count
   the tensor-core instructions (``HGMMA``, ``HMMA``) in uniconv's, flash
   attention's and fused_matmul's libraries, failing where one lacks the
   products its design runs (``SASS_REQUIRED``);
3. kernels against plain: log every distinct shape the ``cuda`` backend
   sees in one FULL micro-step, one SKETCH micro-step and one VAE decode;
   at each, compare kernel and plain version on the card and time kernel,
   plain version and one PyTorch library call on the device alone, with
   the calls queued behind a spin so no host gap enters (``F.conv2d``,
   ``F.group_norm`` + ``F.silu``, ``F.scaled_dot_product_attention``, used as
   yardsticks only), with uniconv's and flash attention's share of both
   their 3xTF32 and their float32 CUDA-core bound; one line per group
   norm shape with its share of the bytes bound, the device kernels one
   call ran (a ``torch.profiler`` trace) and its cluster plan; time
   uniconv's once-per-weight preparation apart; check flash attention's
   causal/window/softcap/GQA options at one small shape;
4. registry kernels: drive ``stream_norm`` and ``fused_matmul``, which no
   served path runs, through ``repro_torch.kernels.KERNEL_REGISTRY`` at
   sd_v14's full-width shapes (counting their launches), then hold each
   result against the plain version and time kernel, plain version and one
   PyTorch library call (``F.layer_norm`` / ``F.rms_norm``; ``torch.mm`` /
   ``torch.addmm`` with the activation as a second call); fused_matmul's
   float32 cases are charged at the 3xTF32 bound, the float32 CUDA-core
   bound printed beside;
5. serve 4 requests (two phase-aware, two all-FULL) through the engine with
   the ``cuda`` backend, counting kernel launches (and uniconv's split-K
   reduce launches apart), then the same stream with the ``eager``
   backend, and compare the latents;
6. serve cached and conditioned: a 12-request stream (a donor, two cold
   churners and its twin; a K=3 variation group; img2img at strengths 0.75
   and 0.4; inpaint with a half mask; one ``draft`` and one ``exact``
   request) on a ``cross`` engine with a 2-slot ring and the spill ring on,
   ``cuda`` (launches counted) then ``eager``: latents and images held
   against each other, host counters equal, FULL->SKETCH, SKETCH->REFINE,
   spill demotions and promotions all above 0; the same stream with the
   cache off (FULL passes without the cache); the txt2img part at
   threshold 0 against the cache off, bitwise equal on ``cuda``;
   ``StaticServer`` against the continuous engine; micro-step times by
   branch class and the cache's own costs (probe, insert, demote, promote);
7. calibrate: the pipeline of ``examples/torch_pas_calibration.py`` at
   sd_v14 (16 steps, 3 batches of 2 prompts): stage 1 (FULL passes that
   capture every up-step's input, copied to the host; shift scores, the
   profile, D* and the outlier blocks) on ``cuda`` (launches counted) and on
   ``eager``, held against each other with the 2-means cost gap and the
   outlier margin printed; the profile saved, loaded through
   ``serving/config.py`` and served (2 requests, ``cross`` cache,
   ``balanced``); stages 2-4 (cost function, plan search, validation of up
   to 6 plans by cosine against the all-FULL sampler) on ``cuda`` (launches
   counted) and ``eager``, qualities and valid plans held against each
   other; the FULL-with-capture micro-step against a FULL one, and the
   copy of one step's captures to the host;
8. serve over HTTP: ``python -m repro_torch.launch.serve --http`` as a
   subprocess on the card (sd_v14, 2 lanes, 8 steps, ``cross`` cache,
   ``cuda``, ``--max-inflight 4``); six payloads sent one at a time through
   the port's ``FrontendClient`` (txt2img ``balanced``, img2img at 0.75, a
   half-mask inpaint, K=2 variations, ``exact``, the first again with
   ``allow_cache: false``), each stream held to the event protocol and its
   ``done`` digest to the digest of the same payload served in the same
   order through an in-process engine built from the same flags (launches
   counted: the three served kernels must launch); a burst of 8 streams
   (429s, one cancelled through ``/cancel``, one by dropping its
   connection) and ``/stats`` after it; the ``exact`` payload again;
   ``/cache/keys`` since 0 and since its version; ``POST /shutdown`` and a
   clean exit; each request's HTTP, driver and in-process latency, and the
   front end's cost per request;
9. serve through the router: ``python -m repro_torch.launch.router`` with
   two replicas of phase 8's server on this card (one process group,
   killed in a ``finally``; the compute mode must let two processes share
   the card); each replica's time to serve and card memory; phase 8's
   ``exact`` payload alone, its replica SIGKILLed after the second step
   event: the stream shows ``requeued`` and restarts once on the survivor,
   and its digest is bitwise phase 8's in-process one, as is the cold
   replay of the first payload; the respawn; 8 of phase 8's payloads from
   4 clients with the busier replica SIGKILLed while every client has a
   stream open (every request ``done``, the victim respawned); a pair of
   new prompts that lands on both replicas; ``POST /shutdown`` (exit 0,
   drained) and each drained replica generation's own launch counts
   (uniconv, group norm and flash attention above 0);
10. the sharded engine: ``ShardedDiffusionEngine`` with its shards on
   ``cuda:0`` and ``cuda:1``, or both on ``cuda:0`` where one card is
   visible.  One shard serves phase 5's stream bitwise equal to the
   single-device engine; two shards of 2 lanes serve phase 6's stream on a
   ``cross`` engine (a 3-slot ring a shard, one shared spill ring,
   ``cache_gossip``), ``cuda`` (launches counted) then ``eager``: latents
   and images held against each other, host counters equal, at least one
   admission redirected to a warm shard, one spill promotion onto another
   shard than the one that demoted it and one step whose shard votes
   differ; the txt2img part at threshold 0 with the spill on against the
   cache off, bitwise on ``cuda``; every per-shard kernel shape phase 3
   did not log held against its plain version and timed; ``python -m
   repro_torch.launch.serve --shards 2`` refused with ``repro``'s message
   on one card (or serving 3 requests on two); the sharded micro-step by
   vote pair beside phase 6's single-device steps;
11. train: ``repro_torch.launch.train.train_unet`` at sd_v14's full width
   on the card (batch 2, 4 steps, a checkpoint every 2, on the ``eager``
   backend under autograd: the kernels have no backward), each step's time
   and the peak card memory; the newest checkpoint restored into a fresh
   template bitwise the live state, and a second call resuming from step 4
   to 6; one sd_toy step on the card against the same step on the CPU
   (loss, parameters, m and v); the pipeline of
   ``examples/torch_train_unet.py`` at sd_100m (train until the loss
   falls, one more step with int8 gradient compression, restore, sample
   all-FULL and PAS on ``cuda``, launches counted, and on ``eager``,
   latents held against each other, the cosine and the MAC reduction);
   every kernel wrapper refuses an operand that requires grad;
12. the LM transformer family (no kernel of ``KERNEL_REGISTRY`` runs on
   it, as no Pallas kernel runs on the reference's LM path; the phase
   fails if one launched): (a) every SMOKE arch, the eight of the
   transformer family and the recurrent xlstm and hymba (random weights
   from a seed), on the card against the same weights on the CPU, TF32 off: forward logits, aux loss, one train step's loss and
   16 teacher-forced decode steps' logits within 1e-4 relative; (b)
   ``python -m repro_torch.launch.train --mode lm --arch yi-6b`` (SMOKE,
   20 steps, a checkpoint every 10) as a subprocess, the mean of its last
   5 losses below its first, then a second run resuming from step 20 to
   30; (c) ``python -m repro_torch.launch.serve --mode lm --arch
   gemma3-1b --requests 4`` as a subprocess; (d) gemma3-1b at its full
   width (1.0 B parameters, bf16, random init): a 1 x 4096 forward (the
   chunked attention branch, q_chunk 512), a batch-4 prefill of 512
   tokens, ``greedy_generate`` over that prompt and 64 generated tokens
   (the 512-slot local rings wrap), every decode step's logits against
   the forward's over the same 576 positions within 5e-2 of max |logit|
   with the argmax agreement printed, then ``train_lm`` at batch 2 x 1024
   for 6 steps: each step's time and the peak card memory;
13. the recurrent LM families and layer skipping (no kernel of
   ``KERNEL_REGISTRY`` may launch; each step prints its wall time and the
   card's name and power limit): (a) hymba-1.5b SMOKE decodes 1040
   positions on the card (its 1024-slot ring wraps) against its own CPU
   run and against its forward on the card, within 1e-4; (b) ``python -m
   repro_torch.launch.train --mode lm --arch hymba-1.5b`` (SMOKE, 4 steps,
   a checkpoint every 2, then a resume to 6) and ``python -m
   repro_torch.launch.serve --mode lm --arch xlstm-350m --requests 4`` as
   subprocesses; (c) xlstm-350m and hymba-1.5b at their full width (bf16,
   random init): a long forward (xlstm 1 x 4096, 16 chunks of 256; hymba
   1 x 2048, past its window), a batch-4 prefill of 512 tokens,
   ``greedy_generate`` over a 64-token prompt with 64 new tokens (bf16
   decode against forward and the argmax agreement printed), the same
   weights upcast to float32: decode against forward over the prompt and
   xlstm's forward in chunks of 16 against one chunk, within 1e-2 of max
   |logit| (``P13_F32_TOL`` says why bf16 is not gated), one traced decode
   step (device ops, busy ms, idle share), and ``train_lm`` (xlstm 2 x
   1024, hymba 1 x 1024) with each step's time and the peak card memory;
   (d) ``core.lm_skip.skip_decode`` on gemma3-1b FULL over 64 tokens at
   batch 4 under ``SkipPlan(1, 1, 2)`` and ``SkipPlan(1, 1, 4)``: ms of a
   FULL and of a SKIP step beside exact ``lm_decode``'s, the logit cosine
   against exact decode (from a random init: a check of the mechanism,
   not of quality) and ``flops_reduction``;
14. mesh costing (no kernel of ``KERNEL_REGISTRY`` may launch): (a) ``python
   -m repro_torch.launch.dryrun`` over all 35 (arch x cell) cells at full
   width, three sweeps started together (``P14_SWEEPS``: 16 x 16 with
   two-point costs, 2 x 16 x 16 layout and memory only, 16 x 16 with the
   optimized ``PerfConfig``), each exiting 0 with 35 ``ok`` cells, and a
   line a cell: per-device argument GiB, estimated peak GiB against the
   card's ``total_memory``, the three roofline terms and the bottleneck;
   (b) gemma3-1b and xlstm-350m FULL costed at ``make_host_mesh()`` (whole
   depth) on a 2 x 1024 train cell and a batch-4 decode cell, then run on
   the card: the predicted argument bytes within 1 % of the allocator's
   rise when the args are placed, the predicted FLOPs equal to
   ``FlopCounterMode`` over the same step on the card; printed beside,
   the predicted temp bytes against the ``max_memory_allocated`` rise and
   the step time against the roofline's ``max(compute, memory)``;
15. distributed train (no kernel of ``KERNEL_REGISTRY`` may launch in a
   rank; each line names the card and its power limit): (a) ``python
   examples/torch_distributed_smoke.py`` as a user starts it (8 ranks on
   a (4, 2) mesh, 6 steps, a checkpoint, an elastic restart onto (3, 2)
   for 3 more) and the same example with ``--device cpu`` on the card's
   host, started together: the 9 losses within 1e-4 relative; (b) gemma3-1b at its
   full width (bf16, seed 0) on 8 ranks of a (4, 2) mesh sharing the card,
   3 steps at 8 x 64 tokens under ``remat``: each loss within 2e-2 of the
   single-process step on the card from the same weights, each rank's
   resident bytes within 1 % of the allocator's rise, its peak memory, the
   step time (slowest rank), the collective bytes by kind beside
   ``collectives_from_specs``, the backend and the bytes staged through
   the host; (c) mixtral-8x22b and qwen3-moe-235b-a22b SMOKE (experts
   stored tensor- and expert-parallel) at (4, 2) on the card against the
   single-process step on the CPU, within 1e-4; (d) where 4 cards are
   visible, (b) at (2, 2) on ``nccl`` with a card a rank, checkpointed
   and restarted onto (1, 2).

Run from the repository root: ``python3 chip_smoke.py``.  It prints the
per-kernel JSON line, the card line and, last, the ``{"ok": true, ...}``
line; any failed phase exits non-zero.  Details go to
``chiprun_out/chip_smoke_detail.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

#: H100 SXM published peaks (NVIDIA data sheet), the port's one copy
#: (``repro_torch.launch.mesh``, which imports no torch): HBM3 rate, float32
#: without tensor cores, TF32 and bfloat16 dense on tensor cores
try:
    from repro_torch.launch.mesh import HBM_BW as MEM_BYTES_S
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_S
    from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_FLOP_S
    from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_FLOP_S
except ImportError:
    sys.exit(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from the repository")
#: the kernels whose float32 products run on the TF32 tensor cores in
#: "3xTF32" (three TF32 products each): their operations bound is
#: 3 x operations / TF32_FLOP_S; the float32 CUDA-core bound is printed beside
#: (fused_matmul's bfloat16 products are charged at BF16_FLOP_S)
TENSOR_CORE_3XTF32 = ("uniconv", "flash_attention", "fused_matmul")
#: tensor-core instructions each library must hold (cuobjdump -sass): HGMMA
#: is a wgmma product, HMMA an mma.sync one
SASS_REQUIRED = {"uniconv": ("HGMMA",), "flash_attention": ("HMMA",), "fused_matmul": ("HGMMA",)}
#: kernel-vs-plain tolerance, relative to max(1, max |plain|): float32 sums in
#: another order (conv over up to 9*2560 terms, group norm over up to 262144)
TOL = {"uniconv": 2e-5, "stream_group_norm": 2e-5, "flash_attention": 1e-4}
#: cuda-vs-eager engine latents, relative to max(1, max |eager latent|): eight
#: guided PNDM steps amplify the per-op float32 differences (measured 1e-5
#: relative on an H100)
SERVE_TOL = 1e-4
#: phase 6 images, cuda vs eager, relative to max(1, max |eager image|): the
#: random-weight decoder passes the latents' float32 differences through
#: about thirty convolutions and group norms
IMAGE_TOL = 1e-3
UNET, N_LANES, MAX_STEPS = "sd_v14", 2, 8
#: phase 6's engine: a 3-slot ring (an sd_v14 slot is f_sk [2, 4096, 640] +
#: f_rf [2, 4096, 320] float32, 30 MiB) with one bucket a step (stride 125
#: at 8 steps), so the ring evicts, over a spill ring of P6_SPILL_SLOTS
#: slots' bytes, so the spill evicts too and still promotes the twin's donor
P6_CACHE = dict(cache_mode="cross", cache_slots=3, cache_t_bucket=125)
P6_SPILL_SLOTS = 4
#: phase 6's host counters, equal across the two backends
P6_COUNTERS = (
    "full_steps", "sketch_steps", "refine_steps", "demoted_full_steps", "demoted_sketch_steps",
    "cache_hit_rate", "hbm_hits", "spill_promotions", "cache_probes", "cache_probe_hits",
    "cache_inserts", "cache_evictions", "cache_spill_demotions", "cache_spill_promotions",
    "quality_mix",
)
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
#: phase 7: the example's calibration schedule and batches (2 prompts each)
CAL_STEPS, CAL_BATCHES = 16, 3
#: phase 7, cuda against eager, absolute: raw shift scores, the min-max
#: normalised profile (a block's range divides its late, small scores, so
#: float32 differences of 1e-6 relative grow about tenfold) and stage-4
#: cosines; the bucket factors of the in-memory profile against the served
#: one, which was saved in float32 (one float32 step)
SCORE_TOL, PROFILE_TOL, COSINE_TOL, FACTOR_TOL = 1e-4, 1e-3, 1e-5, 2.0**-23
#: phase 8: the HTTP server as a user starts it; the same flags, through
#: ``CFG.from_args``, give the in-process reference engine its config
P8_SERVER = "repro_torch.launch.serve"
P8_PORT_FILE = "build/http.port"
P8_ENGINE = [
    "--unet", UNET, "--batch", str(N_LANES), "--timesteps", str(MAX_STEPS), "--cache", "cross",
    "--kernels", "cuda", "--max-inflight", "4",
]
P8_ARGS = [*P8_ENGINE, "--http", "127.0.0.1:0", "--port-file", P8_PORT_FILE]
#: phase 8's digest gate, served one at a time; the last is the first again,
#: opted out of the cache (cold as the first was, so the same digest)
P8_BALANCED = dict(task="txt2img", prompt="a lighthouse at dusk", seed=1, timesteps=MAX_STEPS,
                   quality="balanced")
P8_EXACT = dict(task="txt2img", prompt="a lighthouse at dusk", seed=5, timesteps=MAX_STEPS,
                quality="exact")
P8_PAYLOADS = [
    P8_BALANCED,
    dict(task="img2img", prompt="a barn in snow", seed=2, timesteps=MAX_STEPS,
         init={"seed": 3}, strength=0.75),
    dict(task="inpaint", prompt="a red door", seed=3, timesteps=MAX_STEPS, init={"seed": 4},
         mask={"kind": "half"}),
    dict(task="variations", prompt="an owl", seed=4, timesteps=MAX_STEPS, variants=2),
    P8_EXACT,
    dict(P8_BALANCED, allow_cache=False),
]
#: phase 8's burst: concurrent streams against --max-inflight 4
P8_BURST = 8
#: phase 8's bound on each wait for the server (start-up, a stream, the drain)
P8_WAIT_S = 300
#: phase 9: two replicas of phase 8's server behind the router, all on this
#: card; the run dir (replica port files and logs) comes back with the call
P9_ROUTER = "repro_torch.launch.router"
P9_PORT_FILE = "build/router.port"
P9_RUN_DIR = "chiprun_out/router"
P9_REPLICAS = 2
P9_ARGS = ["--replicas", str(P9_REPLICAS), *P8_ENGINE, "--http", "127.0.0.1:0",
           "--port-file", P9_PORT_FILE, "--run-dir", P9_RUN_DIR]
#: phase 9's kill under load: this many of phase 8's payloads from this many clients
P9_LOAD, P9_CLIENTS = 8, 4
#: phase 10: two lane shards (on cards 0 and 1 where there are two, both on
#: card 0 where there is one) of 2 lanes each, a 3-slot ring a shard with
#: one bucket a step, over one spill ring of P10_SPILL_SLOTS slots' bytes:
#: phase 6's stream then redirects admissions to a warm shard, promotes a
#: capture demoted off one shard onto the other, and splits the shards' votes
P10_SHARDS, P10_LANES = 2, 4
P10_CACHE = P6_CACHE
P10_SPILL_SLOTS = 6
#: phase 10's host counters, equal across the two backends
P10_COUNTERS = P6_COUNTERS + ("gossip_routed", "shard_mean_active", "shard_hit_rates")
#: the vote pairs phase 10 times, by class (0 FULL, 1 SKETCH, 2 REFINE)
P10_PAIRS = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2))
#: phase 11 (a): sd_v14 training at batch 2, a checkpoint every 2 steps, then
#: resumed to P11_RESUME; a checkpoint of params, m and v (float32) is 10.3 GB
#: on disk and keep-2 holds up to three while the third is written
P11_V14 = dict(unet=UNET, batch=2, steps=4, save_every=2, lr=3e-4)
P11_RESUME = 6
P11_DISK_BYTES = 3 * 3 * 4 * 860e6
#: phase 11 (b), sd_toy card against CPU, as tests/test_torch_train.py holds
#: the port against the JAX package in float32: the loss within 1e-5
#: relative; m and v within 1e-4 of each leaf's largest value; parameters
#: within 0.5 * lr absolute (Adam's first step moves an element by about
#: lr * sign(g), so a float32 gradient difference moves an element whose |g|
#: is near Adam's eps by a share of lr)
P11_LOSS_TOL, P11_MV_TOL, P11_PARAM_TOL = 1e-5, 1e-4, 0.5
#: phase 11 (c): the example's pipeline at sd_100m (the example's batch 8),
#: this many steps, then one more with --compress-grads
P11_STEPS, P11_BATCH = 60, 8
#: phase 12 (a): every transformer-family SMOKE arch on the card against the
#: CPU, TF32 off: logits relative to max |CPU logit|, aux and loss relative
P12_B, P12_S, P12_TOL = 2, 16, 1e-4
#: phase 12 (b): the LM trainer as a user starts it, then its resume; lr
#: 3e-3 so that 20 steps visibly lower the loss
P12_TRAIN = "repro_torch.launch.train"
P12_CKPT = "build/p12_lm_ckpt"
P12_TRAIN_ARGS = ["--mode", "lm", "--arch", "yi-6b", "--variant", "smoke", "--batch", "2",
                  "--seq", "16", "--lr", "3e-3", "--ckpt-dir", P12_CKPT, "--save-every", "10",
                  "--log-every", "1"]
P12_STEPS, P12_RESUME = 20, 30
#: phase 12 (c): the LM server as a user starts it
P12_SERVE_ARGS = ["--mode", "lm", "--arch", "gemma3-1b", "--requests", "4"]
#: phase 12 (d): gemma3-1b at its full width, bf16: a 4k forward (the
#: chunked attention branch), a batch-4 prefill of 512 tokens then 64
#: greedy decode steps (the 512-token local rings wrap), teacher-forced
#: decode against forward within 5e-2 of max |logit|, then the trainer
P12_FULL = "gemma3-1b"
P12_LONG, P12_PROMPT, P12_BATCH, P12_GEN = 4096, 512, 4, 64
P12_DECODE_TOL = 5e-2
P12_FULL_TRAIN_ARGS = ["--mode", "lm", "--arch", P12_FULL, "--variant", "full", "--batch", "2",
                       "--seq", "1024", "--steps", "6", "--log-every", "1", "--no-sigterm"]
#: phase 13 (a): hymba SMOKE decoded past its 1024-token window (1040 =
#: HYMBA_WINDOW + 16), card against CPU and decode against forward
P13_WINDOW_ARCH, P13_WINDOW_LEN, P13_TOL = "hymba-1.5b", 1040, 1e-4
#: phase 13 (b): the recurrent trainer and server as a user starts them
P13_CKPT = "build/p13_lm_ckpt"
P13_TRAIN_ARGS = ["--mode", "lm", "--arch", "hymba-1.5b", "--variant", "smoke", "--batch", "2",
                  "--seq", "16", "--lr", "3e-3", "--ckpt-dir", P13_CKPT, "--save-every", "2",
                  "--log-every", "1"]
P13_STEPS, P13_RESUME = 4, 6
P13_SERVE_ARGS = ["--mode", "lm", "--arch", "xlstm-350m", "--requests", "4"]
#: phase 13 (c): arch -> (long forward length, train batch, train seq) at
#: full width, bf16; phase 12 (d)'s 4 x 512 prefill and 64 new tokens, but a
#: 64-token teacher-forced prompt before them: a decode step is host-bound
#: at 50-100 ms, so 512 prompt steps would cost 25-60 s a model.  The gate
#: is float32 (the same weights upcast, TF32 off): decode against forward
#: over the prompt, and xlstm's forward in chunks of 16 against one chunk
#: (the state carried between chunks).  bf16 is printed, not gated: from a
#: random init the reference's own xlstm-350m decode and forward part by
#: 0.65 of max |logit| over 64 positions in bf16 (1.6e-3 in float32;
#: tools/xlstm_decode_drift.py), so no bf16 gate can hold
P13_FULL = {"xlstm-350m": (4096, 2, 1024), "hymba-1.5b": (2048, 1, 1024)}
P13_PROMPT, P13_CARRY_CHUNK, P13_F32_TOL = 64, 16, 1e-2
#: train steps at full width: xlstm's first step carries the warm-up; one
#: hymba step takes 18-21 s (its Python scan under autograd)
P13_TRAIN_STEPS = {"xlstm-350m": 2, "hymba-1.5b": 1}
#: phase 13 (d): layer skipping on gemma3-1b FULL, 64 tokens at batch 4
P13_SKIP_ARCH, P13_SKIP_TOKENS, P13_SKIP_BATCH = "gemma3-1b", 64, 4
P13_SKIP_PLANS = ((1, 1, 2), (1, 1, 4))
P13_SKIP_TOL = 1e-3  # the first (FULL) step against exact decode, of max |logit|
#: phase 14 (a): the dry run as a user runs it, three sweeps of the 35 (arch x
#: cell) cells at full width, started together (host work only: it never
#: touches the card).  The 16 x 16 sweeps count each cell's cost from a 1-unit
#: and a 2-unit copy of its config (``--extrapolate``): a whole-depth meta run
#: walks hymba's selective scan position by position, minutes of host time
#: (tests/test_torch_dryrun.py holds the two equal on every SMOKE arch)
P14_DRYRUN = "repro_torch.launch.dryrun"
P14_SWEEPS = {
    "16x16": ["--all", "--variant", "full", "--extrapolate"],
    "2x16x16": ["--all", "--variant", "full", "--multipod", "--skip-unrolled"],
    "16x16 opt": ["--all", "--variant", "full", "--opt", "--extrapolate"],
}
P14_CELLS, P14_WAIT_S = 35, 600
#: phase 14 (b): the model held against the card at make_host_mesh(): arch ->
#: cells (seq_len, batch), phase 12's train shape and a batch-4 decode
#: against a 1024-deep cache; argument bytes within P14_ARG_TOL of the
#: allocator's rise, FLOPs equal to FlopCounterMode's on the card
P14_FULL = ("gemma3-1b", "xlstm-350m")
P14_SHAPES = (("train_2x1k", 1024, 2, "train"), ("decode_b4", 1024, 4, "decode"))
P14_ARG_TOL, P14_STEPS = 0.01, 3
#: phase 15 (a): the distributed example as a user starts it, on the card and
#: on CPU ranks of the card's host (the same weights: the port's init draws
#: on the CPU's generator), its 9 losses within 1e-4 relative
P15_EXAMPLE = "examples/torch_distributed_smoke.py"
P15_EXAMPLE_TOL, P15_WAIT_S = 1e-4, 400
#: phase 15 (b): gemma3-1b at its full width on a mesh of ranks sharing the
#: card, 3 steps of 8 x 64 tokens (``token_batch`` rows of 65), each loss
#: within 2e-2 relative of the single-process step (bf16 sums in another
#: order over 4 data shards); resident bytes within 1 % of the allocator
P15_FULL_ARCH, P15_FULL_MESH, P15_FULL_STEPS, P15_FULL_TOL = "gemma3-1b", (4, 2), 3, 2e-2
P15_BATCH, P15_SEQ, P15_ARG_TOL = 8, 65, 0.01
#: phase 15 (c): the MoE layer's mesh branch, experts stored TP and EP
P15_MOE, P15_MOE_STEPS, P15_MOE_TOL = ("mixtral-8x22b", "qwen3-moe-235b-a22b"), 2, 1e-4
#: phase 15 (d), where 4 cards are visible: (b) on nccl, then a restart
P15_NCCL_MESH = (2, 2)
P15_RENDEZVOUS = "build/p15_rendezvous"


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
    (err, tol_abs, ms, plain_ms, library_ms, bytes_ms, ops_ms, simt_ms): ops_ms
    on the units the kernel uses (3xTF32 for ``TENSOR_CORE_3XTF32``),
    simt_ms on the float32 CUDA cores."""
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
        nbytes / MEM_BYTES_S * 1e3,
        (3 * flops / TF32_FLOP_S if kind in TENSOR_CORE_3XTF32 else flops / FP32_FLOP_S) * 1e3,
        flops / FP32_FLOP_S * 1e3,
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
    """(bytes_ms, ops_ms, simt_ms) of one phase-4 case: each input read
    once, each output written once, against the peak rate of the units the
    kernel uses (bfloat16 tensor cores; 3xTF32 for float32 products), and
    the float32 CUDA-core time of the same operations."""
    if name == "stream_norm":
        _, m, d, _, _, dt = case
        size = 2 if dt == "bfloat16" else 4
        ops_ms = 8 * m * d / FP32_FLOP_S * 1e3
        return (2 * m * d * size + 2 * d * 4) / MEM_BYTES_S * 1e3, ops_ms, ops_ms
    _, m, k, n, epilogue, with_stats, dt = case
    flops = 2 * m * n * k
    size, ops_ms = (2, flops / BF16_FLOP_S) if dt == "bfloat16" else (4, 3 * flops / TF32_FLOP_S)
    nbytes = (m * k + k * n + m * n) * size + (n * 4 if epilogue != "none" else 0)
    nbytes += 8 * m if with_stats else 0
    return nbytes / MEM_BYTES_S * 1e3, ops_ms * 1e3, flops / FP32_FLOP_S * 1e3


def _registry_phase(torch, K, gen):
    """Drive the registry kernels once (counted), then check and time them.
    Returns (per-kernel totals, rows, failures)."""
    from repro_torch.kernels.fused_matmul.ops import matmul_plan

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
                         bytes_ms=0.0, ops_ms=0.0, simt_ms=0.0) for name in REGISTRY_SOURCES}
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
            bytes_ms, ops_ms, simt_ms = _registry_cost(name, case)
            row = dict(kernel=name, case=list(case), max_abs_err=err, tol=tol,
                       stats_err=stats_err, ms=ms, plain_ms=pms, library_ms=lms,
                       bytes_ms=bytes_ms, ops_ms=ops_ms, simt_ms=simt_ms)
            if name == "fused_matmul":
                row["plan"] = matmul_plan(case[1], case[3], getattr(torch, case[6]))._asdict()
            rows.append(row)
            tot = totals[name]
            tot["err"] = max(tot["err"], err)
            for f in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "simt_ms"):
                tot[f] += row[f]
            bound, simt = max(bytes_ms, ops_ms), max(bytes_ms, simt_ms)
            print(f"[chip_smoke]   {name} {case}: err {err:.3g} (tol {tol:.3g})"
                  + ("" if stats_err is None else f" stats err {stats_err:.3g}")
                  + f" kernel {ms:.4f} ms plain {pms:.4f} ms library {lms:.4f} ms"
                  f" bound {bound:.4f} ms ({bound / ms:.0%})"
                  + (f" f32 SIMT bound {simt:.4f} ms" if name == "fused_matmul" else "")
                  + (f" {row['plan']['route']} tile {row['plan']['bm']}x{row['plan']['bn']}"
                     if name == "fused_matmul" else ""))
    for name, v in totals.items():
        print(f"[chip_smoke]   {name}: {v['launches']} launches, kernel {v['ms']:.3f} ms, "
              f"plain {v['plain_ms']:.3f} ms, library {v['library_ms']:.3f} ms, bound "
              f"{max(v['bytes_ms'], v['ops_ms']):.3f} ms"
              + (f" (f32 SIMT bound {max(v['bytes_ms'], v['simt_ms']):.3f} ms)"
                 if name == "fused_matmul" else ""))
    return totals, rows, failures


def _device_kernels(torch, fn) -> int | None:
    """Kernels the card ran in one call of ``fn``, from a torch.profiler
    trace (CUPTI), or None where the trace shows no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def _group_norm_lines(torch, ops, group_norm_plan, by_key, calls, gen) -> list[dict]:
    """One line per served group norm shape: calls, kernel / plain / library
    ms, share of the bytes bound, kernels the card ran per call (profiler),
    and the plan (cluster x slices x batch, rows a block, on chip)."""
    out = []
    for key, n in sorted(calls.items(), key=lambda kv: str(kv[0])):
        if key[0] != "stream_group_norm":
            continue
        _, xs, groups, silu = key
        row = by_key[key]
        plan = group_norm_plan(xs[0], xs[1], xs[2], groups)
        x = torch.randn(xs, generator=gen, device="cuda")
        sc, bi = torch.ones(xs[2], device="cuda"), torch.zeros(xs[2], device="cuda")
        per_call = _device_kernels(
            torch, lambda: ops["stream_group_norm"](x, sc, bi, groups=groups, silu=silu))
        line = dict(shape=list(xs), groups=groups, silu=silu, calls=n, ms=row["ms"],
                    plain_ms=row["plain_ms"], library_ms=row["library_ms"],
                    bytes_ms=row["bytes_ms"], share=row["bytes_ms"] / row["ms"],
                    kernels_per_call=per_call, plan=plan._asdict(), blocks=plan.blocks)
        out.append(line)
        print(f"[chip_smoke]   group norm {list(xs)} G{groups} silu={silu}: x{n}, kernel "
              f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms library "
              f"{row['library_ms']:.4f} ms, {line['share']:.0%} of the bytes bound "
              f"{row['bytes_ms']:.4f} ms; device kernels a call "
              f"{'not measured' if per_call is None else per_call}; plan: cluster "
              f"{plan.cluster} x {plan.slices} slices of {plan.slice_width} channels x "
              f"batch {plan.batch} = {plan.blocks} blocks, {plan.rows_per_block} rows a block, "
              f"{'on chip' if plan.on_chip else 're-read'}, {plan.smem_bytes} B shared")
    return out


def _kernel_entry(name, src, rep, launches, tot) -> dict:
    return dict(
        name=name, route="cuda", source=src, replaces=rep, launches=launches,
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=max(tot["bytes_ms"], tot["ops_ms"]),
        bound_by="bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        library_ms=tot["library_ms"],
    )


def phase6_stream(np, ucfg, n_up, policy, GenRequest, default_pas_plan, steps=MAX_STEPS):
    """Phase 6's request stream -> [(name, request)], rids in list order,
    made anew (``submit`` annotates requests) from a fixed seed.

    The donor's twin (same prompt and noise) comes last, after the exact and
    draft requests on the same prompt, so the donor's captures have left the
    ring for the spill by the time the twin is admitted; the draft's planned
    SKETCH step finds the exact request's capture on the ring."""
    L, c = ucfg.latent_size**2, ucfg.in_channels
    rng = np.random.default_rng(15)
    prompt = lambda: rng.normal(size=(ucfg.ctx_len, ucfg.ctx_dim)).astype(np.float32)  # noqa: E731
    latent = lambda: rng.normal(size=(L, c)).astype(np.float32)  # noqa: E731
    twin, var, twin_noise = prompt(), prompt(), latent()
    pas = default_pas_plan(steps, n_up)
    out = []

    def add(name, **kw):
        kw.setdefault("timesteps", steps)
        kw.setdefault("plan", pas)
        if kw.get("noise") is None:
            kw["noise"] = latent()
        out.append((name, GenRequest(rid=len(out), **kw)))

    add("donor", ctx=twin, noise=twin_noise)
    add("churn_0", ctx=prompt())
    add("churn_1", ctx=prompt())
    for v in range(3):
        add(f"var_{v}", ctx=var)
    for name, strength in (("img2img_075", 0.75), ("img2img_040", 0.4)):
        n = max(1, round(strength * steps))
        add(name, ctx=prompt(), timesteps=n, base_timesteps=steps, init_latent=latent(),
            plan=default_pas_plan(n, n_up) if n >= 4 else None)
    mask = np.ones((L, 1), np.float32)
    mask[: L // 2] = 0.0
    add("inpaint_half", ctx=prompt(), init_latent=latent(), mask=mask)
    for q in ("exact", "draft"):
        pol = policy.resolve(steps, quality=q)
        add(q, ctx=twin, plan=pol.plan, policy=pol)
    add("twin", ctx=twin, noise=twin_noise)
    return out


def phase10_config(base, slot_bytes: int):
    """Phase 10's cached engine config from the plain one (either package's
    ``EngineConfig``); ``slot_bytes`` is one slot's float32 bytes."""
    return dataclasses.replace(
        base, n_lanes=P10_LANES, n_shards=P10_SHARDS, cache_gossip=True,
        cache_spill_mb=P10_SPILL_SLOTS * slot_bytes / 2**20 * 1.001, **P10_CACHE)


def track_sharded(engine) -> dict:
    """Count, on a two-shard engine of either package, what phase 10
    requires of its stream: ``split`` steps whose two shard votes differ
    (both shards active), and spill ``promotions`` with ``cross`` those of a
    capture that another shard's ring demoted.  Wraps the engine's
    ``step``, its scheduler's ``pick_branch``, each ring's eviction hook and
    the cache's ``promote``; returns the live counts."""
    counts = dict(split=0, promotions=0, cross=0)
    votes: list[int] = []
    pick, step, cache = engine.scheduler.pick_branch, engine.step, engine.cache

    def picking(classes, stalls):
        votes.append(int(pick(classes, stalls)))
        return votes[-1]

    def stepping(*args, **kw):
        votes.clear()
        out = step(*args, **kw)
        counts["split"] += len(votes) == 2 and votes[0] != votes[1]
        return out

    engine.scheduler.pick_branch, engine.step = picking, stepping
    demoted_by: dict[tuple, int] = {}

    def key(ring, slot):
        return int(ring.rid[slot]), int(ring.bucket[slot]), int(ring.offset[slot])

    for d, ring in enumerate(cache.rings):
        if ring.on_evict is None:  # no spill ring
            continue

        def on_evict(slot, d=d, ring=ring, hook=ring.on_evict):
            if ring.valid[slot]:
                demoted_by[key(ring, slot)] = d
            hook(slot)

        ring.on_evict = on_evict
    promote = cache.promote

    def promoting(shard, *args, **kw):
        slot = promote(shard, *args, **kw)
        if slot is not None:
            counts["promotions"] += 1
            counts["cross"] += demoted_by.get(key(cache.rings[shard], slot), shard) != shard
        return slot

    cache.promote = promoting
    return counts


def _serve_cached_phase(torch, np, K, CFG, config, models, t0):
    """Phase 6 -> its detail.  Raises on the first failed check."""
    from repro_torch.core import sampler as SM
    from repro_torch.models import unet as U
    from repro_torch.serving.cache import _upload_slot
    from repro_torch.serving.engine import GenRequest, StaticServer
    from repro_torch.serving.policy import default_pas_plan

    ucfg, dcfg, params, vae_params = models
    n_up = U.n_up_steps(ucfg)
    slot_bytes = 8 * sum(
        math.prod(SM.feat_shape(ucfg, e, 1)) for e in (n_up - config.l_sketch, n_up - config.l_refine))
    cached = dataclasses.replace(
        config, cache_spill_mb=P6_SPILL_SLOTS * slot_bytes / 2**20 * 1.001, **P6_CACHE)
    policy = CFG.build_policy(cached, ucfg, dcfg)
    stream = lambda: phase6_stream(np, ucfg, n_up, policy, GenRequest, default_pas_plan)  # noqa: E731
    names = [name for name, _ in stream()]
    detail: dict = {}

    def serve(cfg, reqs, count=False):
        bundle = CFG.build_engine(cfg, models=models)
        if count:
            K.reset_launch_counts()
        with torch.no_grad():
            done, summary = bundle.engine.run(reqs)
        torch.cuda.synchronize()
        launches = K.launch_counts() if count else None
        if sorted(d.rid for d in done) != sorted(r.rid for r in reqs):
            raise AssertionError(f"phase 6: completed rids {sorted(d.rid for d in done)}")
        for d in done:
            if not np.isfinite(d.latent).all() or (
                    d.image is not None and not np.isfinite(d.image).all()):
                raise AssertionError(f"phase 6: rid {d.rid} ({names[d.rid]}) is not finite")
        return bundle.engine, {d.rid: d for d in done}, summary, launches

    def brief(summary):
        keys = P6_COUNTERS + ("micro_steps", "cache_spill_entries", "step_time_by_backend")
        return {k: summary[k] for k in keys if k in summary}

    runs = {}
    for backend in ("cuda", "eager"):
        engine, done, summary, launches = serve(
            dataclasses.replace(cached, backend=backend), [r for _, r in stream()],
            count=backend == "cuda")
        runs[backend] = (engine, done, summary)
        print(f"[chip_smoke] serve cached {backend}: {brief(summary)}")
        if backend == "cuda":
            cuda_launches = launches
            print(f"[chip_smoke]   phase 6 launches (cuda run): {launches}")
        t0 = _phase(f"serve cached {backend}", t0)
    (eng_c, done_c, sum_c), (_, done_e, sum_e) = runs["cuda"], runs["eager"]
    if any(cuda_launches[name] <= 0 for name in SOURCES):
        raise AssertionError(f"phase 6: a kernel of the path never launched: {cuda_launches}")
    diff = {k: (sum_c[k], sum_e[k]) for k in P6_COUNTERS if sum_c[k] != sum_e[k]}
    if diff:
        raise AssertionError(f"phase 6: host counters differ between cuda and eager: {diff}")
    for key in ("demoted_full_steps", "demoted_sketch_steps", "cache_spill_demotions",
                "spill_promotions"):
        if not sum_c[key] > 0:
            raise AssertionError(f"phase 6: {key} is {sum_c[key]}, the stream must exercise it")
    scale = max(1.0, max(float(np.abs(d.latent).max()) for d in done_e.values()))
    lat_err = max(float(np.abs(done_c[r].latent - done_e[r].latent).max()) for r in done_e)
    img_scale = max(1.0, max(float(np.abs(d.image).max()) for d in done_e.values()))
    img_err = max(float(np.abs(done_c[r].image - done_e[r].image).max()) for r in done_e)
    print(f"[chip_smoke]   latents cuda vs eager: max |d| {lat_err:.3g} on max |latent| "
          f"{scale:.3g} (tol {SERVE_TOL * scale:.3g}); images max |d| {img_err:.3g} on max "
          f"|image| {img_scale:.3g} (tol {IMAGE_TOL * img_scale:.3g})")
    if not lat_err <= SERVE_TOL * scale:
        raise AssertionError(f"phase 6: cuda latents differ from eager by {lat_err}")
    if not img_err <= IMAGE_TOL * img_scale:
        raise AssertionError(f"phase 6: cuda images differ from eager by {img_err}")
    detail.update(cuda=sum_c, eager=sum_e, launches=cuda_launches, latent_err=lat_err,
                  latent_scale=scale, image_err=img_err, image_scale=img_scale)

    # the same stream without the cache: the FULL passes the cache saved
    _, _, sum_off, _ = serve(dataclasses.replace(config, backend="cuda"),
                             [r for _, r in stream()])
    planned_full = sum_off["full_steps"]
    print(f"[chip_smoke]   FULL U-Net passes: {sum_c['full_steps']} with the cache, "
          f"{planned_full} without it ({planned_full - sum_c['full_steps']} saved); SKETCH "
          f"{sum_c['sketch_steps']} / {sum_off['sketch_steps']}, REFINE "
          f"{sum_c['refine_steps']} / {sum_off['refine_steps']}; wall {sum_c['wall_s']} s / "
          f"{sum_off['wall_s']} s")
    # and with the ring but no spill: what the spill's demotions cost (each
    # copies a slot to the host, a device sync)
    _, _, sum_ns, _ = serve(dataclasses.replace(cached, backend="cuda", cache_spill_mb=0.0),
                            [r for _, r in stream()])
    print(f"[chip_smoke]   without the spill ring: {sum_ns['full_steps']} FULL passes, "
          f"{sum_ns['demoted_full_steps']} + {sum_ns['demoted_sketch_steps']} demotions, wall "
          f"{sum_ns['wall_s']} s, {sum_ns['step_time_by_backend']['cuda']['mean_s'] * 1e3:.2f} ms "
          f"a micro-step (with it {sum_c['step_time_by_backend']['cuda']['mean_s'] * 1e3:.2f}, "
          f"cache off {sum_off['step_time_by_backend']['cuda']['mean_s'] * 1e3:.2f})")
    detail.update(cache_off=sum_off, no_spill=sum_ns)
    t0 = _phase("serve cache off, no spill", t0)

    # the exactness guarantee on the card: txt2img at threshold 0 == cache off
    def txt2img():
        reqs = [r for _, r in stream() if r.init_latent is None and r.mask is None]
        for r in reqs:
            r.policy = None  # every lane at the engine threshold
        return reqs

    _, zero, sum_zero, _ = serve(
        dataclasses.replace(cached, backend="cuda", cache_threshold=0.0), txt2img())
    _, off, _, _ = serve(dataclasses.replace(config, backend="cuda"), txt2img())
    unequal = [names[r] for r in off if not np.array_equal(zero[r].latent, off[r].latent)]
    print(f"[chip_smoke]   threshold 0 vs cache off, {len(off)} txt2img requests on cuda: "
          f"{'bitwise equal' if not unequal else 'DIFFER: ' + str(unequal)}; "
          f"{sum_zero['cache_inserts']} inserts, {sum_zero['demoted_full_steps']} demotions")
    if unequal or sum_zero["demoted_full_steps"] or sum_zero["spill_promotions"]:
        raise AssertionError(f"phase 6: threshold-0 cache is not bitwise cache-off: {unequal}")
    t0 = _phase("threshold 0 vs off", t0)

    # the static lockstep baseline against the continuous engine
    pair = lambda: [GenRequest(rid=i, ctx=r.ctx, noise=r.noise, timesteps=MAX_STEPS)  # noqa: E731
                    for i, (_, r) in enumerate(stream()[1:3])]
    server = StaticServer(ucfg, dcfg, params, vae_params, N_LANES, backend="cuda",
                          device=config.device)
    server.warmup([MAX_STEPS])
    with torch.no_grad():
        st_done, st_sum = server.run(pair())
    _, cont, _, _ = serve(dataclasses.replace(config, backend="cuda"), pair())
    st_scale = max(1.0, max(float(np.abs(d.latent).max()) for d in cont.values()))
    st_err = max(float(np.abs(d.latent - cont[d.rid].latent).max()) for d in st_done)
    step_s = server.time_step_s(MAX_STEPS, iters=1)
    print(f"[chip_smoke]   static vs continuous, 2 all-FULL requests on cuda: max |d| "
          f"{st_err:.3g} (tol {SERVE_TOL * st_scale:.3g}); static wall {st_sum['wall_s']} s, "
          f"{step_s * 1e3:.2f} ms a lockstep step (batch {N_LANES})")
    if not st_err <= SERVE_TOL * st_scale:
        raise AssertionError(f"phase 6: StaticServer differs from the engine by {st_err}")
    detail["static"] = dict(summary=st_sum, err=st_err, scale=st_scale, step_ms=step_s * 1e3)

    # micro-step time by branch class on the cached engine (host-inclusive,
    # synchronised), and the cache's own costs
    state, cache = eng_c._state, eng_c.cache
    sel = torch.ones((N_LANES,), dtype=torch.bool, device=config.device)
    src = torch.zeros((N_LANES,), dtype=torch.int64, device=config.device)
    dist = torch.zeros((N_LANES,), device=config.device)
    micro_ms = {}
    with torch.no_grad():
        for label, b in (("FULL", SM.FULL), ("SKETCH", SM.SKETCH), ("REFINE", SM.REFINE)):
            micro_ms[label] = _ms(
                torch, lambda: eng_c._micro(state, b, sel, src, dist, cache.state),
                reps=3, queued=False)
    lanes, slots = np.arange(N_LANES), np.arange(N_LANES) % cache.n_slots
    insert_ms = _ms(torch, lambda: cache.insert_many(state.f_sk, state.f_rf, lanes, slots))
    sig = np.zeros((ucfg.ctx_dim,), np.float32)
    t = time.perf_counter()
    for _ in range(1000):
        cache.probe_distance(750, sig, -1, 0.15, 0)
    probe_us = (time.perf_counter() - t) * 1e3
    cache.reserve(750, sig, -7)  # a new key may evict (and demote); later calls refresh it
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        slot = cache.reserve(750, sig, -7)
        cache.insert_many(state.f_sk, state.f_rf, lanes[:1], np.array([slot]))
    insert_host_us = (time.perf_counter() - t) * 1e4
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache._demote(0)
    torch.cuda.synchronize()
    demote_ms = (time.perf_counter() - t) * 1e3
    entry = next(iter(cache.spill._entries.values()))
    t = time.perf_counter()
    _upload_slot(cache.state, 0, entry.f_sk, entry.f_rf)
    torch.cuda.synchronize()
    promote_ms = (time.perf_counter() - t) * 1e3
    print(f"[chip_smoke]   cached micro-step (2 lanes, CFG batch 4), cuda: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in micro_ms.items())
          + f"; slot {slot_bytes / 2**20:.1f} MiB, insert of {N_LANES} slots {insert_ms:.3f} ms "
          f"(device), reserve + insert of one {insert_host_us:.1f} us (host), probe "
          f"{probe_us:.1f} us (host, {cache.n_slots} slots), demote "
          f"{demote_ms:.2f} ms, promote {promote_ms:.2f} ms (host, synchronised)")
    detail.update(micro_ms=micro_ms, insert_ms=insert_ms, insert_host_us=insert_host_us,
                  probe_us=probe_us,
                  slot_bytes=slot_bytes, demote_ms=demote_ms, promote_ms=promote_ms,
                  names=names)
    _phase("static and cache costs", t0)
    return detail


def _example(name: str):
    """``examples/<name>.py`` as a module (its stage functions are the
    entry points a user calls)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _calibrate_phase(torch, np, K, CFG, config, models, full_pass_ms, t0):
    """Phase 7 -> its detail.  Raises on the first failed check."""
    import argparse

    from repro_torch.common.types import DiffusionConfig
    from repro_torch.core import framework as FW
    from repro_torch.core import phase_division as PD
    from repro_torch.core import sampler as SM
    from repro_torch.core import shift_score as SS
    from repro_torch.launch.serve import make_diffusion_requests
    from repro_torch.models import diffusion as D
    from repro_torch.models import unet as U
    from repro_torch.serving.policy import profile_bucket_factors

    cal = _example("torch_pas_calibration")
    ucfg, _, params, _ = models
    dcfg = DiffusionConfig(timesteps_sample=CAL_STEPS)
    n_up = U.n_up_steps(ucfg)
    dev = config.device
    detail: dict = {}

    def counted(backend, fn):
        """(fn's result, seconds, launches on cuda): counts set to 0 just
        before and read just after."""
        K.reset_launch_counts()
        start = time.perf_counter()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        launches = K.launch_counts() if backend == "cuda" else None
        if backend == "cuda" and any(launches[name] <= 0 for name in SOURCES):
            raise AssertionError(f"phase 7: a kernel of the path never launched: {launches}")
        return out, secs, launches

    # the calibration micro-step: FULL with every up-step captured, then the copy
    ctx, noise = cal.prompt_batch(ucfg, 1, dev)
    ctx2 = torch.cat([ctx, torch.zeros_like(ctx)], dim=0)
    every = tuple(range(n_up))
    with torch.no_grad():
        step = lambda cap: SM.cfg_unet_step(  # noqa: E731
            ucfg, params, dcfg.guidance_scale, noise, 981, ctx2, capture=cap, backend="cuda")
        plain_ms = _ms(torch, lambda: step(()), reps=3, queued=False)
        cap_ms = _ms(torch, lambda: step(every), reps=3, queued=False)
        _, cap = step(every)
        torch.cuda.synchronize()
        copy_ms = []
        for _ in range(3):
            start = time.perf_counter()
            host = {k: v.to("cpu", copy=True) for k, v in cap.items()}
            copy_ms.append((time.perf_counter() - start) * 1e3)
        cap_mib = sum(v.numel() * v.element_size() for v in host.values()) / 2**20
        del cap, host
    print(f"[chip_smoke]   calibration micro-step (CFG batch {2 * cal.BATCH}), cuda: FULL "
          f"capturing all {n_up} up-steps {cap_ms:.2f} ms, FULL {plain_ms:.2f} ms (phase 3's "
          f"FULL pass {full_pass_ms:.2f} ms); copy of the {cap_mib:.1f} MiB of captures to the "
          f"host {min(copy_ms):.2f}-{max(copy_ms):.2f} ms a step "
          f"({cap_mib / 2**10 / (min(copy_ms) / 1e3):.2f} GiB/s)")
    detail.update(capture_ms=cap_ms, full_ms=plain_ms, full_pass_ms=full_pass_ms,
                  copy_ms=copy_ms, capture_mib=cap_mib)

    # stage 1 on both backends
    stage1 = {}
    for backend in ("cuda", "eager"):
        (profile, runs), secs, launches = counted(backend, lambda: cal.profile_prompts(
            ucfg, dcfg, params, CAL_BATCHES, dev, backend))
        d_star = PD.find_transition(profile)
        costs = np.sort(PD.transition_costs(profile))
        per_block, thresh = SS.late_scores(profile.scores)
        margin = float(np.abs(per_block - thresh).min())
        stage1[backend] = (profile, runs, d_star)
        print(f"[chip_smoke]   stage 1 {backend}: {secs:.1f} s, D* {d_star}, outlier blocks "
              f"{profile.outlier_blocks}; 2-means cost best {costs[0]:.6g}, next "
              f"{costs[1]:.6g} (gap {costs[1] - costs[0]:.3g}); outlier margin {margin:.3g} "
              f"(threshold {thresh:.4f})" + (f"; launches {launches}" if launches else ""))
        detail[f"stage1_{backend}"] = dict(
            seconds=secs, launches=launches, d_star=d_star, outliers=profile.outlier_blocks,
            cost_gap=float(costs[1] - costs[0]), outlier_margin=margin,
            scores=profile.scores.tolist())
        t0 = _phase(f"calibrate stage 1 {backend}", t0)
    (prof_c, runs_c, d_c), (prof_e, runs_e, d_e) = stage1["cuda"], stage1["eager"]
    scale = max(1.0, max(float(x.abs().max()) for x, _ in runs_e))
    lat_err = max(float((xc - xe).abs().max()) for (xc, _), (xe, _) in zip(runs_c, runs_e))
    score_err = max(float(np.abs(sc - se).max()) for (_, sc), (_, se) in zip(runs_c, runs_e))
    prof_err = float(np.abs(prof_c.scores - prof_e.scores).max())
    print(f"[chip_smoke]   stage 1 cuda vs eager: latents max |d| {lat_err:.3g} on max |latent| "
          f"{scale:.3g} (tol {SERVE_TOL * scale:.3g}); raw scores {score_err:.3g} (tol "
          f"{SCORE_TOL}); profile {prof_err:.3g} (tol {PROFILE_TOL})")
    detail.update(latent_err=lat_err, latent_scale=scale, score_err=score_err,
                  profile_err=prof_err)
    if not lat_err <= SERVE_TOL * scale:
        raise AssertionError(f"phase 7: cuda latents differ from eager by {lat_err}")
    if not (score_err <= SCORE_TOL and prof_err <= PROFILE_TOL):
        raise AssertionError(f"phase 7: scores differ by {score_err}, profiles by {prof_err}")
    if (d_c, prof_c.outlier_blocks) != (d_e, prof_e.outlier_blocks):
        raise AssertionError(f"phase 7: D* / outliers {d_c} {prof_c.outlier_blocks} on cuda, "
                             f"{d_e} {prof_e.outlier_blocks} on eager")

    # the profile round trip: saved, loaded by the serve path, served
    (ROOT / "build").mkdir(exist_ok=True)
    path = str(ROOT / "build" / "calibration_profile.npz")
    ts = D.sample_timesteps(dcfg).numpy()
    SS.save_profile(path, prof_c, ts=ts)
    args = argparse.Namespace(
        batch=N_LANES, timesteps=MAX_STEPS, unet=config.unet, cache="cross", quality="balanced",
        profile=path, device=dev, kernels=config.backend, requests=2, pas=False, seed=0)
    bundle = CFG.build_engine(CFG.from_args(args), models=models)
    loaded, loaded_ts = SS.load_profile(path)
    bucket = dict(t_train=dcfg.timesteps_train, t_bucket=bundle.config.cache_t_bucket)
    served = bundle.policy.bucket_factors
    in_memory = profile_bucket_factors(prof_c, ts, **bucket)
    factor_err = max(abs(a - b) for a, b in zip(served, in_memory))
    print(f"[chip_smoke]   profile {path}: served bucket factors {served}; in memory max |d| "
          f"{factor_err:.3g} (tol {FACTOR_TOL:.3g})")
    if served != profile_bucket_factors(loaded, loaded_ts, **bucket) or not (
            len(served) == len(in_memory) and factor_err <= FACTOR_TOL):
        raise AssertionError(f"phase 7: served factors {served}, in memory {in_memory}")
    with torch.no_grad():
        done, summary = bundle.engine.run(make_diffusion_requests(args, ucfg, bundle.policy))
    torch.cuda.synchronize()
    if sorted(d.rid for d in done) != [0, 1] or not all(
            np.isfinite(d.latent).all() for d in done):
        raise AssertionError(f"phase 7: served {sorted(d.rid for d in done)}, or not finite")
    keys = ("wall_s", "full_steps", "sketch_steps", "refine_steps", "quality_mix")
    print(f"[chip_smoke]   served 2 requests with the profile (cross, balanced): "
          f"{ {k: summary[k] for k in keys} }")
    detail.update(bucket_factors=served, factor_err=factor_err, served=summary)
    t0 = _phase("calibrate profile served", t0)

    # stages 2-4 on both backends
    cons = cal.plan_constraints(CAL_STEPS, prof_c, d_c)
    f = FW.cost_function(ucfg)
    sols = FW.search_plans(ucfg, cons)
    print(f"[chip_smoke]   stage 2 f(l) = {[round(f(l), 3) for l in range(1, n_up + 1)]}; stage 3: "
          f"{len(sols)} feasible plans under {cons}")
    if not sols:
        raise AssertionError("phase 7: no feasible plan")
    t0 = _phase("calibrate stages 2-3", t0)
    stage4 = {}
    for backend in ("cuda", "eager"):
        cands = [FW.Solution(s.plan, s.mac_reduction) for s in sols]
        valid, secs, launches = counted(backend, lambda: cal.validate_plans(
            ucfg, dcfg, params, cands, cons.min_quality, dev, backend))
        evaluated = [s for s in cands if s.quality is not None]
        stage4[backend] = (evaluated, valid)
        print(f"[chip_smoke]   stage 4 {backend}: {secs:.1f} s, qualities "
              f"{[round(s.quality, 6) for s in evaluated]}, {len(valid)} valid"
              + (f"; launches {launches}" if launches else ""))
        detail[f"stage4_{backend}"] = dict(
            seconds=secs, launches=launches,
            evaluated=[(dataclasses.astuple(s.plan), s.mac_reduction, s.quality)
                       for s in evaluated],
            valid=[dataclasses.astuple(s.plan) for s in valid])
        t0 = _phase(f"calibrate stage 4 {backend}", t0)
    (ev_c, valid_c), (ev_e, valid_e) = stage4["cuda"], stage4["eager"]
    q_err = max(abs(a.quality - b.quality) for a, b in zip(ev_c, ev_e))
    print(f"[chip_smoke]   stage 4 cuda vs eager: cosine max |d| {q_err:.3g} (tol {COSINE_TOL})")
    detail["quality_err"] = q_err
    if not (len(ev_c) == len(ev_e) and q_err <= COSINE_TOL):
        raise AssertionError(f"phase 7: stage-4 qualities differ by {q_err}")
    if [s.plan for s in valid_c] != [s.plan for s in valid_e]:
        raise AssertionError("phase 7: the valid plans differ between cuda and eager")
    if valid_c:
        best = valid_c[0]
        print(f"[chip_smoke]   best plan {best.plan}: MAC reduction {best.mac_reduction:.2f}x at "
              f"quality {best.quality:.4f}")
    else:
        print(f"[chip_smoke]   no plan met the quality bar {cons.min_quality}")
    return detail


def _check_stream(events: list[dict], payload: dict, where: str = "phase 8") -> dict:
    """The event protocol of one stream: ``queued`` first, then per member
    the step events k = 1..n in order, exactly one terminal event, last;
    it must be ``done``.  Returns the terminal event."""
    kinds = [ev["event"] for ev in events]
    terminal = [k for k in kinds if k in ("done", "cancelled", "error")]
    if not kinds or kinds[0] != "queued" or terminal != ["done"] or kinds[-1] != "done":
        raise AssertionError(f"{where}: {payload} streamed {kinds}")
    done, k = events[-1], payload.get("variants", 1)
    for v in range(k):
        steps = [ev["step"] for ev in events
                 if ev["event"] == "step" and ev.get("variant", 0) == v]
        if steps != list(range(1, done["steps"] + 1)):
            raise AssertionError(f"{where}: {payload} variant {v} stepped {steps}")
    if kinds.count("variant_done") != (k if k > 1 else 0):
        raise AssertionError(f"{where}: {payload}: {kinds.count('variant_done')} variant_done")
    return done


def _check_failover(events: list[dict], payload: dict) -> dict:
    """A stream whose replica died once after its second step: ``queued``
    and steps 1..k (k >= 2) from the first replica, exactly one
    ``requeued``, then a whole stream from the survivor (``queued``, steps
    from 1 again, ``done``).  Returns the terminal event."""
    kinds = [ev["event"] for ev in events]
    if kinds.count("requeued") != 1:
        raise AssertionError(f"phase 9: {payload} streamed {kinds}")
    cut = kinds.index("requeued")
    steps = [ev["step"] for ev in events[:cut] if ev["event"] == "step"]
    if kinds[0] != "queued" or kinds[1:cut] != ["step"] * len(steps) or len(steps) < 2 or (
            steps != list(range(1, len(steps) + 1))):
        raise AssertionError(f"phase 9: {payload} streamed {kinds} before its requeue")
    return _check_stream(events[cut + 1:], payload, "phase 9, after the requeue")


async def _http_phase(port: int) -> dict:
    """Phase 8 against the live server: the digest gate, the burst, the
    exact payload again, the keys and the drain."""
    import asyncio

    from repro_torch.serving.client import FrontendClient, RequestRejected, _read_response_head

    client = FrontendClient("127.0.0.1", port)
    out = dict(health=await client.wait_ready(P8_WAIT_S), served=[])

    async def one(payload):
        t = time.perf_counter()
        events = [ev async for ev in client.generate_stream(**payload)]
        return _check_stream(events, payload), time.perf_counter() - t

    for payload in P8_PAYLOADS:
        out["served"].append(await one(payload))

    # the burst: A is cancelled through /cancel and B by dropping its
    # connection, each after its first step; the other six arrive while both
    # are open, so at most two of them fit under --max-inflight 4
    burst = [dict(task="txt2img", prompt=f"burst {i}", seed=100 + i, timesteps=MAX_STEPS)
             for i in range(P8_BURST)]
    queued = [asyncio.Event(), asyncio.Event()]

    async def by_cancel():
        last, sent = None, False
        async for ev in client.generate_stream(**burst[0]):
            queued[0].set()
            if ev["event"] == "step" and not sent:
                sent = True
                await client.cancel(ev["rid"])
            last = ev
        return last

    async def by_drop():
        stream = client.generate_stream(**burst[1])
        try:
            async for ev in stream:
                queued[1].set()
                if ev["event"] == "step":
                    return ev
        finally:
            await stream.aclose()  # closes the connection mid-denoise

    async def plain(payload):
        try:
            return await client.generate(**payload)
        except RequestRejected as e:
            if e.status != 429:
                raise
            return {"event": "rejected", "status": e.status}

    ta, tb = asyncio.create_task(by_cancel()), asyncio.create_task(by_drop())
    await asyncio.wait_for(asyncio.gather(queued[0].wait(), queued[1].wait()), P8_WAIT_S)
    rest = await asyncio.gather(*(plain(p) for p in burst[2:]))
    a, b = await ta, await tb
    out["burst"] = dict(cancelled=a, dropped_after=b, rest=[ev["event"] for ev in rest])
    if a["event"] != "cancelled" or a.get("where") != "lane":
        raise AssertionError(f"phase 8: the /cancel stream ended with {a}")
    if not any(ev["event"] == "rejected" for ev in rest):
        raise AssertionError(f"phase 8: no 429 in the burst: {out['burst']['rest']}")
    if any(ev["event"] not in ("done", "rejected") for ev in rest):
        raise AssertionError(f"phase 8: the burst's streams ended with {out['burst']['rest']}")
    deadline = time.perf_counter() + P8_WAIT_S
    while (stats := await client.stats())["open"] and time.perf_counter() < deadline:
        await asyncio.sleep(0.1)
    out["stats"] = stats

    out["exact_again"] = await one(P8_EXACT)
    keys = await client.cache_keys(0)
    out["keys"] = dict(version=keys["version"], rows=keys["rings"][0],
                       later=(await client.cache_keys(keys["version"]))["rings"])
    reader, writer = await client._connect()
    try:
        writer.write(client._head("POST", "/shutdown", b"{}"))
        await writer.drain()
        out["shutdown_status"], _ = await _read_response_head(reader)
    finally:
        writer.close()
    return out


def _serve_http_phase(torch, K, t0):
    """Phase 8 -> its detail.  Raises on the first failed check; the server
    process never outlives the phase."""
    import ast
    import asyncio
    import os
    import re

    from repro_torch.launch import serve
    from repro_torch.serving import config as CFG
    from repro_torch.serving.driver import group_digest, latent_digest
    from repro_torch.serving.frontend import RequestFactory

    cfg = CFG.from_args(serve.build_parser().parse_args(P8_ARGS), decode_images=False)
    port_file = ROOT / P8_PORT_FILE
    port_file.parent.mkdir(exist_ok=True)
    port_file.unlink(missing_ok=True)
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    with open(logs / "http_server.out", "w") as so, open(logs / "http_server.err", "w") as se:
        proc = subprocess.Popen([sys.executable, "-m", P8_SERVER, *P8_ARGS], cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=so, stderr=se)
    try:
        deadline = time.perf_counter() + P8_WAIT_S
        while not port_file.exists():
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"phase 8: the server never bound a port (exit {proc.poll()})")
            time.sleep(0.2)
        port = int(port_file.read_text())
        t0 = _phase(f"http server up on port {port}", t0)

        # the in-process reference: the same config, weights from the same
        # (unet, seed), the same payloads in the same order, one at a time
        bundle = CFG.build_engine(cfg)
        engine = bundle.engine
        factory = RequestFactory(bundle.ucfg, bundle.dcfg, cfg, policy=bundle.policy,
                                 default_quality=cfg.quality)
        K.reset_launch_counts()
        ref = []
        for payload in P8_PAYLOADS + [P8_EXACT]:
            reqs, gid, _ = factory.build(payload)
            t = time.perf_counter()
            for r in reqs:
                engine.submit(r)
            done = {}
            while engine.n_pending or engine.n_active:
                done.update((d.rid, d) for d in engine.step())
            torch.cuda.synchronize()
            lat = time.perf_counter() - t
            digests = [latent_digest(done[r.rid].latent) for r in reqs]
            ref.append((digests[0] if gid is None else group_digest(digests), digests, lat))
        ref_launches = K.launch_counts()
        print(f"[chip_smoke]   in-process reference launches: {ref_launches}")
        if any(ref_launches[name] <= 0 for name in SOURCES):
            raise AssertionError(f"phase 8: a kernel of the reference never launched: "
                                 f"{ref_launches}")
        del bundle, engine
        torch.cuda.empty_cache()
        t0 = _phase("http in-process reference", t0)

        out = asyncio.run(asyncio.wait_for(_http_phase(port), 2 * P8_WAIT_S))
        rc = proc.wait(timeout=P8_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    server_out = (logs / "http_server.out").read_text()
    # the server zeroes its counts once its engine is built and prints them
    # in its drained line: the launches of the HTTP path's own run
    m = re.search(r"\[serve\] drained .*'launches': (\{[^{}]*\})", server_out)
    launches = ast.literal_eval(m.group(1)) if m else {}
    print(f"[chip_smoke]   server launches: {launches}")
    if any(launches.get(name, 0) <= 0 for name in SOURCES):
        raise AssertionError(f"phase 8: a kernel of the HTTP path never launched: "
                             f"{server_out[-2000:]}")

    rows = []
    for payload, (done, http_s), (digest, digests, ref_s) in zip(
        P8_PAYLOADS + [P8_EXACT], out["served"] + [out["exact_again"]], ref
    ):
        if done["latent_digest"] != digest or done.get("variant_digests", digests) != digests:
            raise AssertionError(f"phase 8: {payload} served {done['latent_digest']}, "
                                 f"in process {digest}")
        rows.append(dict(payload=payload, digest=digest, http_s=http_s, driver_s=done["latency_s"],
                         in_process_s=ref_s, front_end_ms=1e3 * (http_s - ref_s)))
        print(f"[chip_smoke]   {payload['task']} {payload.get('quality', '')}: digest {digest} "
              f"(= in process), HTTP {1e3 * http_s:.2f} ms, driver {1e3 * done['latency_s']:.2f} "
              f"ms, in process {1e3 * ref_s:.2f} ms, front end {1e3 * (http_s - ref_s):.2f} ms")
    if rows[0]["digest"] != rows[5]["digest"]:
        raise AssertionError("phase 8: allow_cache false did not serve the cold digest")
    # the first request also pays the server process's own warm-up (CUDA
    # context, library handles, allocator, kernel loads), which this process
    # paid in phases 3-7: the front end's cost is read over the later ones
    def spread(key):  # (median, least, most) over requests 2..n
        v = sorted(r[key] for r in rows[1:])
        return v[len(v) // 2], v[0], v[-1]

    for r in rows:
        r["edge_ms"] = 1e3 * (r["http_s"] - r["driver_s"])
        r["driver_ms"] = 1e3 * (r["driver_s"] - r["in_process_s"])
    cost, edge, drv = spread("front_end_ms"), spread("edge_ms"), spread("driver_ms")
    print(f"[chip_smoke]   front end's cost per request, requests 2-{len(rows)}: median "
          f"{cost[0]:.2f} ms ({cost[1]:.2f} to {cost[2]:.2f}): HTTP edge (HTTP - driver) "
          f"{edge[0]:.2f} ms ({edge[1]:.2f} to {edge[2]:.2f}), driver thread (driver - in "
          f"process) {drv[0]:.2f} ms ({drv[1]:.2f} to {drv[2]:.2f}); first request "
          f"{rows[0]['front_end_ms']:.2f} ms (with the server's warm-up)")
    stats = out["stats"]
    print(f"[chip_smoke]   burst of {P8_BURST}: {out['burst']['rest']} and two cancels; "
          f"/stats accepted {stats['accepted']} completed {stats['completed']} cancelled "
          f"{stats['cancelled']} rejected {stats['rejected']} kernels {stats['kernels']} "
          f"step time {stats['step_time_by_backend']}")
    if (stats["accepted"] != stats["completed"] + stats["cancelled"] or stats["cancelled"] != 2
            or stats["rejected"] < 1 or stats["open"] or stats["kernels"] != "cuda"
            or "cuda" not in stats["step_time_by_backend"]):
        raise AssertionError(f"phase 8: /stats after the burst: {stats}")
    keys = out["keys"]
    print(f"[chip_smoke]   /cache/keys: version {keys['version']}, {len(keys['rows'])} rows since "
          f"0, {keys['later']} since {keys['version']}; /shutdown {out['shutdown_status']}, "
          f"server exit {rc}")
    if (not keys["rows"] or not all(0 < r["gen"] <= keys["version"] for r in keys["rows"])
            or keys["later"] != [[]]):
        raise AssertionError(f"phase 8: /cache/keys: {keys}")
    if out["shutdown_status"] != 202 or rc != 0 or "drained" not in server_out:
        raise AssertionError(f"phase 8: shutdown {out['shutdown_status']}, exit {rc}: "
                             f"{server_out[-2000:]}")
    _phase("http served", t0)
    stats = {k: v for k, v in stats.items() if k != "cache_slots_summary"}
    return dict(requests=rows, launches=launches, reference_launches=ref_launches,
                health=out["health"], stats=stats,
                burst=out["burst"], keys_version=keys["version"], key_rows=len(keys["rows"]))


async def _router_phase(port: int, pids: dict, t_start: float, free_bytes) -> dict:
    """Phase 9 against the live router: the failover of a lone request,
    the cold replay, the respawn, the kill under load, a pair that lands on
    both replicas, the drain.  ``free_bytes()`` reads the card's free
    memory just before the drain."""
    import asyncio
    import os
    import signal

    from repro_torch.serving.client import FrontendClient, run_load

    client = FrontendClient("127.0.0.1", port)
    out: dict = {}

    async def wait_fleet(respawns: int) -> tuple[dict, float]:
        """/stats once both replicas serve again after ``respawns`` respawns."""
        deadline = time.perf_counter() + P8_WAIT_S
        while True:
            stats = await client.stats()
            r = stats["router"]
            if r["ready"] == P9_REPLICAS and r["respawns"] >= respawns:
                return stats, time.perf_counter()
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 9: the fleet never healed: {r}")
            await asyncio.sleep(0.2)

    # the lone request, its replica killed after its second step
    events, t = [], {}
    t["sent"] = time.perf_counter()
    async for ev in client.generate_stream(**P8_EXACT):
        events.append(ev)
        if ev["event"] == "step" and ev["step"] == 2 and "kill" not in t:
            victim = events[0]["replica"]
            os.kill(pids[victim], signal.SIGKILL)
            t["kill"] = time.perf_counter()
        elif ev["event"] == "requeued":
            t["requeued"] = time.perf_counter()
    t["done"] = time.perf_counter()
    out["failover"] = dict(done=_check_failover(events, P8_EXACT), victim=victim,
                           kinds=[ev["event"] for ev in events],
                           kill_to_requeued_s=t["requeued"] - t["kill"],
                           kill_to_done_s=t["done"] - t["kill"], request_s=t["done"] - t["sent"])
    out["replay"] = _check_stream(
        [ev async for ev in client.generate_stream(**dict(P8_BALANCED, allow_cache=False))],
        P8_BALANCED, "phase 9, the replay")
    out["healed"], t_ready = await wait_fleet(1)
    out["failover"]["kill_to_ready_s"] = t_ready - t["kill"]

    # the kill under load: the replica with more open streams dies while
    # every client has one open
    pids = {e["idx"]: e["pid"] for e in out["healed"]["replicas"]}
    load = asyncio.create_task(run_load(
        client, requests=P9_LOAD, concurrency=P9_CLIENTS,
        payloads=[P8_PAYLOADS[i % len(P8_PAYLOADS)] for i in range(P9_LOAD)]))
    deadline = time.perf_counter() + P8_WAIT_S
    while True:
        reps = (await client.stats())["replicas"]
        if sum(e["inflight_routed"] > 0 for e in reps) == P9_REPLICAS or load.done():
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 9: the load never reached both replicas: {reps}")
        await asyncio.sleep(0.05)
    await asyncio.sleep(0.5)  # into the denoise
    busiest = max(reps, key=lambda e: e["inflight_routed"])
    killed_open = not load.done()
    os.kill(pids[busiest["idx"]], signal.SIGKILL)
    t_kill = time.perf_counter()
    stats = await asyncio.wait_for(load, 2 * P8_WAIT_S)
    out["load"] = dict(stats.summary(), victim=busiest["idx"], killed_open=killed_open,
                       victim_inflight=busiest["inflight_routed"])
    out["reheal"], t_ready = await wait_fleet(2)
    out["load"]["kill_to_ready_s"] = t_ready - t_kill

    # a pair of new prompts (cold on both replicas, so least-loaded picks):
    # the second is admitted while the first is open, so it lands on the
    # other replica and every generation that drains has served
    pair = [dict(P8_EXACT, prompt=f"a pair {i}") for i in range(2)]
    first = client.generate_stream(**pair[0])
    head = [await first.__anext__()]
    second = [ev async for ev in client.generate_stream(**pair[1])]
    head += [ev async for ev in first]
    out["pair"] = [dict(_check_stream(evs, p, "phase 9, the pair"), replica=evs[0]["replica"])
                   for evs, p in zip((head, second), pair)]
    out["final"] = await client.stats()
    out["free_served"] = free_bytes()
    await client.shutdown()
    out["wall_s"] = time.perf_counter() - t_start
    return out


def _router_phase_run(torch, p8_rows, t0):
    """Phase 9 -> its detail.  Raises on the first failed check; neither the
    router nor any replica outlives the phase (one process group)."""
    import ast
    import asyncio
    import contextlib
    import os
    import re
    import shutil
    import signal

    t_start = t0
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[chip_smoke]   compute mode: {mode}")
    if mode in ("Exclusive_Process", "Prohibited"):
        raise AssertionError(f"phase 9: compute mode {mode}: {P9_REPLICAS} replica processes "
                             "cannot share the card")
    port_file, run_dir = ROOT / P9_PORT_FILE, ROOT / P9_RUN_DIR
    port_file.parent.mkdir(exist_ok=True)
    port_file.unlink(missing_ok=True)
    shutil.rmtree(run_dir, ignore_errors=True)  # replica logs are appended to
    run_dir.mkdir(parents=True)
    # the card's free memory before the fleet, with it up and after it
    # served: the replicas' own memory (nvidia-smi lists no pids it can map
    # to processes in a container)
    free = [torch.cuda.mem_get_info()[0]]
    t_wall = time.time()  # the replicas' port files are stamped on this clock
    with open(run_dir / "router.out", "w") as so, open(run_dir / "router.err", "w") as se:
        proc = subprocess.Popen([sys.executable, "-m", P9_ROUTER, *P9_ARGS], cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=str(SRC)), stdout=so,
                                stderr=se, start_new_session=True)
    try:
        deadline = time.perf_counter() + P8_WAIT_S
        while not port_file.exists():
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"phase 9: the router never bound a port (exit "
                                     f"{proc.poll()}): {(run_dir / 'router.err').read_text()[-3000:]}")
            time.sleep(0.1)
        port = int(port_file.read_text())
        # each replica's first generation publishes its port once it serves
        ready_s = {i: (run_dir / f"replica{i}.gen1.port").stat().st_mtime - t_wall
                   for i in range(P9_REPLICAS)}
        from repro_torch.serving.client import FrontendClient

        stats = asyncio.run(FrontendClient("127.0.0.1", port).stats())
        if stats["router"]["ready"] != P9_REPLICAS:
            raise AssertionError(f"phase 9: {stats['router']}")
        pids = {e["idx"]: e["pid"] for e in stats["replicas"]}
        free.append(torch.cuda.mem_get_info()[0])
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
        mem = {int(a.split(",")[0]): a.split(",")[1].strip() for a in apps if "," in a}
        for i in range(P9_REPLICAS):
            print(f"[chip_smoke]   replica {i} (pid {pids[i]}) serving {ready_s[i]:.2f} s "
                  f"after the router started; nvidia-smi memory {mem.get(pids[i], 'not listed')}")
        print(f"[chip_smoke]   nvidia-smi compute apps: {apps}; card memory the fleet took "
              f"(mem_get_info): {(free[0] - free[1]) / 2**30:.2f} GiB for {P9_REPLICAS} replicas")
        t0 = _phase(f"router up on port {port}", t0)
        out = asyncio.run(asyncio.wait_for(
            _router_phase(port, pids, t_start, lambda: torch.cuda.mem_get_info()[0]),
            4 * P8_WAIT_S))
        rc = proc.wait(timeout=P8_WAIT_S)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # the router and every replica it started
        proc.wait(timeout=60)

    digests = {name: p8_rows[i]["digest"] for i, name in ((0, "balanced"), (4, "exact"))}
    fo = out["failover"]
    print(f"[chip_smoke]   failover of {fo['kinds'].count('step')} step events: replica "
          f"{fo['victim']} killed after step 2; kill to requeued {1e3 * fo['kill_to_requeued_s']:.1f}"
          f" ms, to done {1e3 * fo['kill_to_done_s']:.1f} ms, to the fleet ready again "
          f"{fo['kill_to_ready_s']:.2f} s; request {1e3 * fo['request_s']:.1f} ms")
    if fo["done"]["latent_digest"] != digests["exact"]:
        raise AssertionError(f"phase 9: the failed-over exact request served "
                             f"{fo['done']['latent_digest']}, in process {digests['exact']}")
    if out["replay"]["latent_digest"] != digests["balanced"]:
        raise AssertionError(f"phase 9: the cold replay served {out['replay']['latent_digest']}, "
                             f"in process {digests['balanced']}")
    healed = out["healed"]["router"]
    print(f"[chip_smoke]   digests: failed-over exact and cold replay = phase 8's in process; "
          f"healed fleet {healed}")
    if healed["evictions"] < 1 or healed["respawns"] < 1 or healed["failed"]:
        raise AssertionError(f"phase 9: after the failover: {healed}")
    load = out["load"]
    ratio = load["completed"] / load["submitted"]
    print(f"[chip_smoke]   kill under load ({P9_LOAD} requests, {P9_CLIENTS} clients): replica "
          f"{load['victim']} killed with routed weight {load['victim_inflight']} open (a "
          f"variation group weighs K); completion ratio "
          f"{ratio:.3f} ({load['completed']} done, {load['failed']} failed, {load['rejected']} "
          f"429s retried); respawned, ready {load['kill_to_ready_s']:.2f} s after the kill; "
          f"wall {load['wall_s']:.2f} s")
    if ratio != 1.0 or load["failed"] or not load["killed_open"]:
        raise AssertionError(f"phase 9: kill under load: {load}")
    pair = out["pair"]
    fleet_gib = [(free[0] - free[1]) / 2**30, (free[0] - out["free_served"]) / 2**30]
    print(f"[chip_smoke]   pair on replicas {[p['replica'] for p in pair]}; card memory of the "
          f"fleet {fleet_gib[0]:.2f} GiB when it came up, {fleet_gib[1]:.2f} GiB after serving "
          f"(mean a replica {fleet_gib[1] / P9_REPLICAS:.2f} GiB)")
    if {p["replica"] for p in pair} != set(range(P9_REPLICAS)):
        raise AssertionError(f"phase 9: the pair: {pair}")
    final = out["final"]["router"]
    if final["failed"] or final["respawns"] < 2 or final["resubmitted"] < 2:
        raise AssertionError(f"phase 9: final router counters {final}")
    router_out = (run_dir / "router.out").read_text()
    print(f"[chip_smoke]   router exit {rc}; final counters {final}")
    if rc != 0 or "'drained': True" not in router_out:
        raise AssertionError(f"phase 9: router exit {rc}: {router_out[-3000:]}")
    # every generation that drained prints its own launch counts
    launches = {}
    for i in range(P9_REPLICAS):
        text = (run_dir / f"replica{i}.log").read_text()
        launches[i] = [ast.literal_eval(m) for m in
                       re.findall(r"\[serve\] drained .*'launches': (\{[^{}]*\})", text)]
        print(f"[chip_smoke]   replica {i}: {len(launches[i])} drained generation(s), launches "
              f"{launches[i]}")
        if len(launches[i]) != 1 or any(c[name] <= 0 for c in launches[i] for name in SOURCES):
            raise AssertionError(f"phase 9: replica {i}'s drained launches {launches[i]}: "
                                 f"{text[-2000:]}")
    _phase(f"router served (phase 9 wall {out['wall_s']:.1f} s)", t0)
    return dict(compute_mode=mode, ready_s=ready_s, nvidia_smi_apps=apps, fleet_gib=fleet_gib,
                launches=launches,
                failover={k: v for k, v in fo.items() if k != "done"}, load=load, pair=pair,
                healed=healed, final=final, wall_s=out["wall_s"])


def _other_card_check(torch, K) -> dict[str, float]:
    """Every kernel of ``KERNEL_REGISTRY`` on operands on ``cuda:1``, called
    while ``cuda:0`` is the current device, against its plain version:
    each wrapper must launch on its operands' card.  -> max |kernel -
    plain| by kernel; raises past the kernel's tolerance."""
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    cases = {
        "uniconv": ((r(2, 256, 64), r(9, 64, 128) / 24, r(128), (16, 16), 3), {}),
        "stream_group_norm": ((r(2, 256, 64), r(64), r(64)), dict(groups=32, silu=True)),
        "flash_attention": ((r(2, 4, 77, 40), r(2, 4, 77, 40), r(2, 4, 77, 40)),
                            dict(causal=False)),
        "stream_norm": ((r(64, 320), r(320), r(320)), {}),
        "fused_matmul": ((r(128, 320), r(320, 256) / 18, r(256)), dict(epilogue="gelu")),
    }
    errs = {}
    with torch.no_grad(), torch.cuda.device(0):
        for name, (args, kw) in cases.items():
            kern, plain = K.KERNEL_REGISTRY[name]
            got, ref = kern(*args, **kw), plain(*args, **kw)
            if name == "fused_matmul":
                got, ref = got[0], ref[0]
            torch.cuda.synchronize(dev)
            errs[name] = float((got - ref).abs().max())
            tol = {**TOL, **REG_TOL}[name] * max(1.0, float(ref.abs().max()))
            if not (got.device == dev and errs[name] <= tol):
                raise AssertionError(f"phase 10: {name} on cuda:1 from cuda:0's context: "
                                     f"{got.device}, max |kernel - plain| {errs[name]} > {tol}")
    return errs


def _sharded_phase(torch, np, K, CFG, config, models, phase5, log, check_shape, single_ms,
                   t0):
    """Phase 10 -> its detail.  Raises on the first failed check.

    ``phase5`` is (its request builder, its ``cuda`` results by rid),
    ``log`` phase 3's shape log, ``check_shape(key)`` phase 3's kernel
    check at one shape and ``single_ms`` phase 6's micro-step times by
    class."""
    import os

    from repro_torch.core import sampler as SM
    from repro_torch.models import unet as U
    from repro_torch.models import vae as V
    from repro_torch.models.backend import CUDA, KernelBackend
    from repro_torch.serving.engine import GenRequest, ShardedDiffusionEngine
    from repro_torch.serving.policy import default_pas_plan

    ucfg, dcfg, params, vae_params = models
    n_up = U.n_up_steps(ucfg)
    count = torch.cuda.device_count()
    devices = [f"cuda:{d % count}" for d in range(P10_SHARDS)]
    print(f"[chip_smoke]   shard devices: {devices} ({count} visible)")
    detail: dict = dict(devices=devices)
    t_phase = time.perf_counter()

    def serve(cfg, reqs, devs, count_launches=False):
        eng = ShardedDiffusionEngine(ucfg, dcfg, params, vae_params, cfg,
                                     scheduler=CFG.default_scheduler(cfg), devices=devs)
        tracked = track_sharded(eng) if eng.cache is not None else None
        if count_launches:
            K.reset_launch_counts()
        with torch.no_grad():
            done, summary = eng.run(reqs)
        torch.cuda.synchronize()
        launches = K.launch_counts() if count_launches else None
        if sorted(d.rid for d in done) != sorted(r.rid for r in reqs):
            raise AssertionError(f"phase 10: completed rids {sorted(d.rid for d in done)}")
        for d in done:
            if not np.isfinite(d.latent).all() or (
                    d.image is not None and not np.isfinite(d.image).all()):
                raise AssertionError(f"phase 10: rid {d.rid} is not finite")
        return eng, {d.rid: d for d in done}, summary, launches, tracked

    # one shard on the engine's card: bitwise the single-device engine (phase 5)
    requests, single = phase5
    _, one, sum_one, _, _ = serve(dataclasses.replace(config, backend="cuda"), requests(),
                                  [devices[0]])
    unequal = [r for r in single if not (np.array_equal(one[r].latent, single[r].latent)
                                         and np.array_equal(one[r].image, single[r].image))]
    print(f"[chip_smoke]   one shard vs DiffusionEngine, phase 5's {len(single)} requests on "
          f"cuda: {'bitwise equal' if not unequal else 'DIFFER: ' + str(unequal)} (latents and "
          f"images); {sum_one['micro_steps']} micro-steps")
    if unequal:
        raise AssertionError(f"phase 10: one shard differs from the single engine: {unequal}")
    t0 = _phase("sharded, one shard", t0)

    # two shards, cached and conditioned, cuda (launches counted) then eager
    slot_bytes = 8 * sum(math.prod(SM.feat_shape(ucfg, e, 1))
                         for e in (n_up - config.l_sketch, n_up - config.l_refine))
    cached = phase10_config(config, slot_bytes)
    policy = CFG.build_policy(cached, ucfg, dcfg)
    stream = lambda: [r for _, r in phase6_stream(  # noqa: E731
        np, ucfg, n_up, policy, GenRequest, default_pas_plan)]
    runs = {}
    for backend in ("cuda", "eager"):
        runs[backend] = serve(dataclasses.replace(cached, backend=backend), stream(), devices,
                              count_launches=backend == "cuda")
        eng, _, summary, launches, tracked = runs[backend]
        print(f"[chip_smoke] serve sharded {backend}: "
              f"{ {k: summary[k] for k in P10_COUNTERS + ('micro_steps', 'wall_s')} }; "
              f"split votes {tracked['split']}, spill promotions {tracked['promotions']} "
              f"({tracked['cross']} onto another shard)"
              + (f"; launches {launches}" if launches else ""))
        t0 = _phase(f"serve sharded {backend}", t0)
    (eng_c, done_c, sum_c, launches, tr_c), (_, done_e, sum_e, _, tr_e) = (
        runs["cuda"], runs["eager"])
    if any(launches[name] <= 0 for name in SOURCES):
        raise AssertionError(f"phase 10: a kernel of the path never launched: {launches}")
    diff = {k: (sum_c[k], sum_e[k]) for k in P10_COUNTERS if sum_c[k] != sum_e[k]}
    if diff or tr_c != tr_e:
        raise AssertionError(f"phase 10: host counters differ, cuda vs eager: {diff} "
                             f"{tr_c} {tr_e}")
    if not (sum_c["gossip_routed"] >= 1 and tr_c["cross"] >= 1 and tr_c["split"] >= 1):
        raise AssertionError(f"phase 10: gossip_routed {sum_c['gossip_routed']}, cross-shard "
                             f"promotions {tr_c['cross']}, split votes {tr_c['split']}: the "
                             "stream must exercise each")
    scale = max(1.0, max(float(np.abs(d.latent).max()) for d in done_e.values()))
    lat_err = max(float(np.abs(done_c[r].latent - done_e[r].latent).max()) for r in done_e)
    img_scale = max(1.0, max(float(np.abs(d.image).max()) for d in done_e.values()))
    img_err = max(float(np.abs(done_c[r].image - done_e[r].image).max()) for r in done_e)
    print(f"[chip_smoke]   latents cuda vs eager: max |d| {lat_err:.3g} on max |latent| "
          f"{scale:.3g} (tol {SERVE_TOL * scale:.3g}); images max |d| {img_err:.3g} on max "
          f"|image| {img_scale:.3g} (tol {IMAGE_TOL * img_scale:.3g})")
    if not lat_err <= SERVE_TOL * scale:
        raise AssertionError(f"phase 10: cuda latents differ from eager by {lat_err}")
    if not img_err <= IMAGE_TOL * img_scale:
        raise AssertionError(f"phase 10: cuda images differ from eager by {img_err}")
    detail.update(one_shard=sum_one, cuda=sum_c, eager=sum_e, launches=launches,
                  tracked=tr_c, latent_err=lat_err, latent_scale=scale, image_err=img_err,
                  image_scale=img_scale)

    # threshold 0 with the spill on: the txt2img part bitwise the cache off
    def txt2img():
        reqs = [r for r in stream() if r.init_latent is None and r.mask is None]
        for r in reqs:
            r.policy = None  # every lane at the engine threshold
        return reqs

    quiet = dict(backend="cuda", decode_images=False)
    _, zero, sum_zero, _, _ = serve(
        dataclasses.replace(cached, cache_threshold=0.0, **quiet), txt2img(), devices)
    _, off, _, _, _ = serve(dataclasses.replace(cached, cache_mode="off", **quiet), txt2img(),
                            devices)
    unequal = [r for r in off if not np.array_equal(zero[r].latent, off[r].latent)]
    print(f"[chip_smoke]   two shards, threshold 0 (spill on) vs cache off, {len(off)} txt2img "
          f"requests on cuda: {'bitwise equal' if not unequal else 'DIFFER: ' + str(unequal)}; "
          f"{sum_zero['cache_inserts']} inserts, {sum_zero['cache_spill_demotions']} spill "
          f"demotions, {sum_zero['demoted_full_steps']} demotions")
    if unequal or sum_zero["demoted_full_steps"] or sum_zero["spill_promotions"]:
        raise AssertionError(f"phase 10: threshold 0 is not bitwise cache off: {unequal}")
    t0 = _phase("sharded threshold 0 vs off", t0)

    # the per-shard kernel shapes phase 3 did not log, held against plain and timed
    p = eng_c.lanes_per_shard
    shard_log = ShapeLog(KernelBackend, CUDA)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((p, ucfg.latent_size**2, ucfg.in_channels), generator=gen, device="cuda")
    t = torch.tensor([981 - 120 * i for i in range(p)], device="cuda")
    ctx2 = torch.randn((2 * p, ucfg.ctx_len, ucfg.ctx_dim), generator=gen, device="cuda")
    e_sk, e_rf = eng_c.e_sk, eng_c.e_rf
    with torch.no_grad():
        shard_log.phase = f"FULL shard pass (CFG batch {2 * p})"
        _, cap = SM.cfg_unet_step(ucfg, params, 7.5, x, t, ctx2, capture=(e_sk, e_rf),
                                  backend=shard_log.backend)
        for label, e in (("SKETCH", e_sk), ("REFINE", e_rf)):
            shard_log.phase = f"{label} shard pass (CFG batch {2 * p})"
            SM.cfg_unet_step(ucfg, params, 7.5, x, t, ctx2, entry_step=e, entry_feat=cap[e],
                             backend=shard_log.backend)
        shard_log.phase = "VAE decode (one image)"
        V.vae_decode(vae_params, x[:1], (ucfg.latent_size,) * 2, backend=shard_log.backend)
        del cap
        new = sorted((k for k in shard_log.calls if k not in log.calls), key=str)
        rows = []
        for key in new:
            err, tol, ms, pms, lms, bytes_ms, ops_ms, _ = check_shape(key)
            rows.append(dict(key=list(key), max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                             library_ms=lms, bound_ms=max(bytes_ms, ops_ms)))
            print(f"[chip_smoke]   new shape {key}: err {err:.3g} (tol {tol:.3g}) kernel "
                  f"{ms:.4f} ms plain {pms:.4f} ms library {lms:.4f} ms bound "
                  f"{max(bytes_ms, ops_ms):.4f} ms")
            if not err <= tol:
                raise AssertionError(f"phase 10: {key}: max |kernel - plain| {err} > {tol}")
    print(f"[chip_smoke]   per-shard kernel shapes (P = {p}): {len(shard_log.calls)} distinct, "
          f"{len(new)} not in phase 3's log")
    detail["new_shapes"] = rows
    t0 = _phase("sharded kernel shapes", t0)

    # the CLI on this machine: --shards 2 serves where two cards are visible,
    # and is refused with repro's message where one is
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--shards", "2", "--unet", UNET,
         "--batch", "2", "--timesteps", str(MAX_STEPS), "--requests", "3"],
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    if count < 2:
        ok = cli.returncode != 0 and "needs 2 visible devices" in cli.stderr
        what = "refused on one card"
    else:
        ok = cli.returncode == 0 and "'shards': 2" in cli.stdout
        what = "served 3 requests on two cards"
    tail = (cli.stderr.strip().splitlines() or [""])[-1]
    print(f"[chip_smoke]   serve --shards 2 ({count} visible): exit {cli.returncode}, {what}: "
          f"{'as required' if ok else 'NOT as required'}; {tail[:200]}")
    if not ok:
        raise AssertionError(f"phase 10: serve --shards 2 on {count} cards: {cli.stderr[-2000:]}")
    detail["cli"] = dict(visible=count, exit=cli.returncode, checked=what)
    t0 = _phase("sharded CLI", t0)

    if count >= 2:  # the kernels launch on their operands' card, whichever is current
        errs = _other_card_check(torch, K)
        print(f"[chip_smoke]   kernels on cuda:1 called from cuda:0: max |kernel - plain| "
              f"{errs}")
        detail["other_card_errs"] = errs

    # the sharded micro-step by vote pair, host wall time with every shard's
    # card synchronised, beside phase 6's single-device steps
    state, cache = eng_c._state, eng_c.cache
    n = cached.n_lanes
    sel = np.ones((n,), bool)
    src, dist = np.zeros((n,), np.int64), np.zeros((n,), np.float32)
    names = ("FULL", "SKETCH", "REFINE")

    def sync():
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)

    def wall_ms(fn, reps=3):
        fn()
        sync()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - start) / reps * 1e3

    pair_ms = {}
    with torch.no_grad():
        for pair in P10_PAIRS:
            b_arr = np.asarray(pair, np.int64)
            pair_ms["/".join(names[b] for b in pair)] = wall_ms(
                lambda: eng_c._micro(state, b_arr, sel, src, dist, cache.state))
    print(f"[chip_smoke]   sharded micro-step ({P10_SHARDS} shards x {p} lanes, CFG batch "
          f"{2 * p} a shard, on {devices}), cuda: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in pair_ms.items())
          + "; single-device (phase 6, CFG batch 4): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in single_ms.items()))
    wall = time.perf_counter() - t_phase
    print(f"[chip_smoke]   phase 10 wall {wall:.1f} s")
    detail.update(pair_ms=pair_ms, single_ms=single_ms, wall_s=wall)
    _phase("sharded micro-step times", t0)
    return detail


def _train_phase(torch, np, K, t0):
    """Phase 11 -> its detail.  Raises on the first failed check."""
    import argparse
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.common.types import DiffusionConfig
    from repro_torch.configs import get_unet_config
    from repro_torch.data.pipeline import DataConfig, latent_batch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_matmul.ops import fused_matmul
    from repro_torch.kernels.stream_norm.ops import stream_group_norm, stream_norm
    from repro_torch.kernels.uniconv.ops import uniconv
    from repro_torch.launch import train as TT
    from repro_torch.models import unet as U
    from repro_torch.optim import AdamWConfig, init_adamw

    detail: dict = {}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)

    # (a) sd_v14 at its full width
    ckpt = build_dir / "p11_sd_v14_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    free = shutil.disk_usage(build_dir).free
    print(f"[chip_smoke]   disk free under build/: {free / 1e9:.1f} GB (checkpoints need "
          f"{P11_DISK_BYTES / 1e9:.1f} GB)")
    if free < P11_DISK_BYTES:
        raise AssertionError(f"phase 11: {free / 1e9:.1f} GB free, sd_v14 checkpoints need "
                             f"{P11_DISK_BYTES / 1e9:.1f} GB")
    args = argparse.Namespace(**P11_V14, seed=0, ckpt_dir=str(ckpt), log_every=1,
                              compress_grads=False, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what the earlier phases still hold
    start = time.perf_counter()
    res = TT.train_unet(args)
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    state = res["state"]
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    steps_ms = [round(s * 1e3, 2) for s in res["step_s"]]
    print(f"[chip_smoke]   sd_v14 train ({n_params / 1e6:.1f} M parameters, batch "
          f"{args.batch}): steps {steps_ms} ms (host wall, loss read back), peak card memory "
          f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before), first loss {res['first_loss']:.5f}, mean "
          f"{res['final_loss']:.5f}; {wall:.1f} s with init and 2 checkpoints")
    cm = CheckpointManager(str(ckpt))
    if not (np.isfinite(res["first_loss"]) and np.isfinite(res["final_loss"])):
        raise AssertionError(f"phase 11: sd_v14 losses {res['first_loss']}, {res['final_loss']}")
    if cm.list_steps() != [2, 4]:
        raise AssertionError(f"phase 11: committed steps {cm.list_steps()}, want [2, 4]")
    start = time.perf_counter()
    fresh = U.init_unet(get_unet_config(UNET), torch.Generator(device="cuda").manual_seed(123))
    step, restored = cm.restore_latest({"params": fresh, "opt": init_adamw(fresh)})
    restore_s = time.perf_counter() - start
    same = step == 4 and all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                             for a, b in zip(tree_leaves(restored), tree_leaves(state)))
    print(f"[chip_smoke]   restore_latest into a fresh template: step {step}, bitwise the "
          f"live state: {same} ({restore_s:.1f} s)")
    if not same:
        raise AssertionError("phase 11: the restored sd_v14 state is not the live one")
    detail["sd_v14"] = dict(n_params=n_params, step_ms=steps_ms, peak_bytes=peak, held_bytes=held,
                            wall_s=wall,
                            first_loss=res["first_loss"], final_loss=res["final_loss"],
                            restore_s=restore_s)
    del fresh, restored, state, res
    torch.cuda.empty_cache()
    res2 = TT.train_unet(argparse.Namespace(**{**vars(args), "steps": P11_RESUME}))
    print(f"[chip_smoke]   resumed from step {res2['start_step']}: steps "
          f"{[round(s * 1e3, 2) for s in res2['step_s']]} ms, loss {res2['final_loss']:.5f}; "
          f"committed {cm.list_steps()}")
    if (res2["start_step"], len(res2["step_s"]), cm.list_steps()) != (4, 2, [4, 6]) or not (
            np.isfinite(res2["final_loss"])):
        raise AssertionError(f"phase 11: the resumed run started at {res2['start_step']}, "
                             f"committed {cm.list_steps()}")
    detail["sd_v14"]["resumed_step_ms"] = [s * 1e3 for s in res2["step_s"]]
    del res2
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = _phase("train sd_v14", t0)

    # (b) one sd_toy step on the card against the same step on the CPU
    toy = get_unet_config("sd_toy")
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=1)
    step_fn = TT.make_unet_train_step(toy, DiffusionConfig(), opt_cfg)
    nb = latent_batch(DataConfig(global_batch=2, seq_len=0, vocab_size=8), 0,
                      size=toy.latent_size)
    # prompt embeddings, not the one-hot class rows: with one row repeated over
    # the context, cross attention's q / k gradients are 0 up to float32 noise,
    # which Adam scales to +-lr on either device
    ctx = torch.randn((2, toy.ctx_len, toy.ctx_dim), generator=torch.Generator().manual_seed(2))
    batch = {"latents": torch.from_numpy(nb["latents"]), "ctx": ctx * 0.5}
    draws = TT.draw_noise(DiffusionConfig(), torch.Generator().manual_seed(1), batch["latents"])
    cpu_params = U.init_unet(toy, torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda x: x.to(dev), cpu_params)
        p, opt, _, loss = step_fn(params, init_adamw(params), None,
                                  tree_map(lambda x: x.to(dev), batch),
                                  *(x.to(dev) for x in draws))
        out[dev] = (float(loss), *(
            [x.cpu() for x in tree_leaves(tree)] for tree in (p, opt.m, opt.v)))
    (loss_c, p_c, m_c, v_c), (loss_g, p_g, m_g, v_g) = out["cpu"], out["cuda"]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    param_err = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c)) / opt_cfg.lr
    mv_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                 for xs, ys in ((m_g, m_c), (v_g, v_c)) for a, b in zip(xs, ys))
    print(f"[chip_smoke]   sd_toy step, cuda vs cpu: loss {loss_g:.7f} vs {loss_c:.7f} (rel "
          f"{loss_err:.3g}, tol {P11_LOSS_TOL}); parameters max |d| {param_err:.3g} lr (tol "
          f"{P11_PARAM_TOL}); m, v max |d| {mv_err:.3g} of the leaf's max (tol {P11_MV_TOL})")
    detail["toy_step"] = dict(loss_rel=loss_err, param_err_lr=param_err, mv_err=mv_err)
    if not (loss_err <= P11_LOSS_TOL and param_err <= P11_PARAM_TOL and mv_err <= P11_MV_TOL):
        raise AssertionError("phase 11: the sd_toy step on the card differs from the CPU's")
    t0 = _phase("train sd_toy card vs cpu", t0)

    # (c) the example's pipeline at sd_100m
    ex = _example("torch_train_unet")
    ucfg = get_unet_config("sd_100m")
    ckpt = build_dir / "p11_sd_100m_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = argparse.Namespace(unet="sd_100m", steps=P11_STEPS, batch=P11_BATCH,
                              ckpt_dir=str(ckpt), save_every=P11_STEPS // 2,
                              compress_grads=False, device="cuda")
    start = time.perf_counter()
    res = ex.train(args)  # exits unless the loss fell
    train_s = time.perf_counter() - start
    comp = TT.train_unet(argparse.Namespace(
        **{**vars(args), "steps": P11_STEPS + 1, "save_every": P11_STEPS + 1,
           "compress_grads": True}, lr=2e-4, seed=0, log_every=1))
    step, params = ex.restore(ucfg, str(ckpt), "cuda")
    sd100_ms = sorted(s * 1e3 for s in res["step_s"])
    print(f"[chip_smoke]   sd_100m: {P11_STEPS} steps at batch {P11_BATCH} in {train_s:.1f} s "
          f"(median step {sd100_ms[len(sd100_ms) // 2]:.2f} ms), loss {res['first_loss']:.4f} -> "
          f"{res['final_loss']:.4f} (mean of the last 10); one step with int8 compression, "
          f"loss {comp['final_loss']:.4f}; restored step {step}")
    if step != P11_STEPS + 1 or comp["start_step"] != P11_STEPS or not np.isfinite(
            comp["final_loss"]):
        raise AssertionError(f"phase 11: compressed step from {comp['start_step']}, restored "
                             f"step {step}")
    lat, launches = {}, None
    for backend in ("cuda", "eager"):
        K.reset_launch_counts()
        start = time.perf_counter()
        lat[backend] = ex.sample(ucfg, params, "cuda", backend)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        if backend == "cuda":
            launches = K.launch_counts()
        print(f"[chip_smoke]   sample {backend} (all-FULL and PAS, {ex.SAMPLE_STEPS} steps): "
              f"{secs:.2f} s" + (f"; launches {launches}" if backend == "cuda" else ""))
    if any(launches[name] <= 0 for name in SOURCES):
        raise AssertionError(f"phase 11: a kernel of the sampling path never launched: {launches}")
    scale = max(1.0, max(float(x.abs().max()) for x in lat["eager"]))
    err = max(float((a - b).abs().max()) for a, b in zip(lat["cuda"], lat["eager"]))
    from repro_torch.core import framework as FW
    from repro_torch.core.metrics import latent_cosine

    full, pas = lat["cuda"]
    cos, red = latent_cosine(pas, full), FW.mac_reduction(ucfg, ex.PLAN, ex.SAMPLE_STEPS)
    print(f"[chip_smoke]   latents cuda vs eager: max |d| {err:.3g} on max |latent| {scale:.3g} "
          f"(tol {SERVE_TOL * scale:.3g}); PAS vs full cosine {cos:.4f}, MAC reduction "
          f"{red:.2f}x")
    if not err <= SERVE_TOL * scale:
        raise AssertionError(f"phase 11: cuda latents differ from eager by {err}")
    if not all(bool(torch.isfinite(x).all()) for x in (*lat["cuda"], *lat["eager"])):
        raise AssertionError("phase 11: sampled latents are not finite")
    detail["sd_100m"] = dict(steps=P11_STEPS, batch=P11_BATCH, train_s=train_s,
                             step_ms=[s * 1e3 for s in res["step_s"]],
                             first_loss=res["first_loss"], final_loss=res["final_loss"],
                             compressed_loss=comp["final_loss"], launches=launches,
                             latent_err=err, latent_scale=scale, cosine=cos, mac_reduction=red)
    del params, lat, comp, res
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = _phase("train the example's pipeline", t0)

    # (d) the grad guard on the card
    w = torch.randn((9, 8, 8), device="cuda", requires_grad=True)
    x = torch.randn((1, 16, 8), device="cuda")
    calls = {
        "uniconv": lambda: uniconv(x, w, None, (4, 4), 3),
        "stream_norm": lambda: stream_norm(x, w[0, 0]),
        "stream_group_norm": lambda: stream_group_norm(x, w[0, 0], w[0, 1], groups=2),
        "flash_attention": lambda: flash_attention(w[:1, None, :4, :8], x[:, None], x[:, None]),
        "fused_matmul": lambda: fused_matmul(x[0], w[0]),
    }
    refused = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" in str(e):
                refused.append(name)
                continue
            raise
    print(f"[chip_smoke]   grad guard: refused an operand that requires grad: {refused}")
    if refused != list(calls):
        raise AssertionError(f"phase 11: only {refused} refused an operand that requires grad")
    detail["grad_guard"] = refused
    _phase("train grad guard", t0)
    return detail


def _run_cli(cmd: list[str], name: str, timeout: float) -> str:
    """Run ``cmd`` from the repository root (output kept in
    ``chiprun_out/<name>.{out,err}``); its stdout, or raise."""
    import os

    out = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=timeout)
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    (logs / f"{name}.out").write_text(out.stdout)
    (logs / f"{name}.err").write_text(out.stderr)
    if out.returncode != 0:
        raise AssertionError(f"phase 12: {' '.join(cmd[1:])} exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return out.stdout


def _train_losses(stdout: str) -> dict[int, float]:
    import re

    return {int(m[0]): float(m[1]) for m in re.findall(r"\[train\] step=(\d+) loss=(\S+)", stdout)}


def _lm_smoke_archs(torch, np, t0) -> dict:
    """Phase 12 (a): every SMOKE arch, card against CPU."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import ARCH_IDS, get_lm_config
    from repro_torch.launch.steps import get_adapter, make_train_step
    from repro_torch.optim import AdamWConfig, init_adamw

    out = {}
    for arch in ARCH_IDS:
        cfg = get_lm_config(arch, "smoke")
        ad = get_adapter(cfg)
        rng = np.random.default_rng(12)
        x = (rng.normal(size=(P12_B, P12_S, cfg.d_model)).astype(np.float32) if cfg.frontend_stub
             else rng.integers(0, cfg.vocab_size, size=(P12_B, P12_S)).astype(np.int32))
        lshape = (P12_B, P12_S) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
        labels = rng.integers(0, cfg.vocab_size, size=lshape).astype(np.int32)
        toks = rng.integers(0, cfg.vocab_size, size=(P12_B, P12_S)).astype(np.int32)
        cpu_params = ad.init(torch.Generator().manual_seed(0), "cpu")
        res = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda t: t.to(dev), cpu_params)
            with torch.no_grad():
                logits, aux = ad.forward(params, torch.from_numpy(x).to(dev))
                cache, steps, tok = ad.init_cache(P12_B, P12_S, dev), [], torch.from_numpy(toks)
                for pos in range(P12_S):
                    lg, cache = ad.decode(params, cache, tok[:, pos].to(dev), pos)
                    steps.append(lg)
            step = make_train_step(ad, AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1),
                                   remat=False)
            batch = {"inputs": torch.from_numpy(x).to(dev),
                     "labels": torch.from_numpy(labels).to(dev)}
            _, _, loss = step(params, init_adamw(params), batch)
            res[dev] = (logits.float().cpu(), float(aux), torch.stack(steps, 1).float().cpu(),
                        float(loss))
        (lc, ac, dc, sc), (lg_, ag, dg, sg) = res["cpu"], res["cuda"]
        errs = dict(
            logits=float((lg_ - lc).abs().max() / lc.abs().max()),
            aux=abs(ag - ac) / max(abs(ac), 1e-30) if cfg.moe is not None else abs(ag - ac),
            decode=float((dg - dc).abs().max() / dc.abs().max()),
            loss=abs(sg - sc) / abs(sc),
        )
        print(f"[chip_smoke]   {arch} SMOKE cuda vs cpu (rel): " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f"; loss {sg:.5f}, aux {ag:.5f}")
        if not all(np.isfinite(v) and v <= P12_TOL for v in errs.values()):
            raise AssertionError(f"phase 12: {arch} on the card differs from the CPU: {errs}")
        out[arch] = errs
    _phase("lm SMOKE archs card vs cpu", t0)
    return out


def _device_busy(torch, fn) -> dict:
    """One call of ``fn`` (after a warm one) traced by torch.profiler: the
    device activities the card ran (kernels, copies, fills), their summed
    device time, and the call's host wall time (traced, synchronised)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    acts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in acts) / 1e3
    return dict(device_ops=len(acts), busy_ms=busy_ms, wall_ms=wall_ms,
                idle_share=1 - busy_ms / wall_ms if acts else None)


def _lm_full(torch, np, t0) -> dict:
    """Phase 12 (d): gemma3-1b at its full width from a random init."""
    import argparse

    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_lm_config
    from repro_torch.launch import serve as TS
    from repro_torch.launch import train as TT
    from repro_torch.launch.steps import get_adapter, make_prefill_step
    from repro_torch.models.attention import adaptive_q_chunk

    cfg = get_lm_config(P12_FULL, "full")
    ad = get_adapter(cfg)
    detail: dict = {}
    torch.cuda.empty_cache()
    start = time.perf_counter()
    params = ad.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[chip_smoke]   {P12_FULL} FULL: {n_params / 1e9:.4f} B parameters in the tree "
          f"(param_count {cfg.param_count() / 1e9:.4f} B, which leaves out the norms), "
          f"{cfg.dtype}, d_model {cfg.d_model}, head_dim {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}; init {time.perf_counter() - start:.1f} s")
    if {p.dtype for p in tree_leaves(params)} != {torch.bfloat16, torch.float32}:
        raise AssertionError("phase 12: the full model is not bf16 with float32 norms")
    rng = np.random.default_rng(13)

    # the 4k forward: the chunked branch, q_chunk 512
    long = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, P12_LONG))).cuda()
    q_chunk = adaptive_q_chunk(P12_LONG)
    with torch.no_grad():
        fwd_ms = _ms(torch, lambda: ad.forward(params, long), reps=2, queued=False)
        logits, _ = ad.forward(params, long)
    finite = bool(torch.isfinite(logits).all())
    print(f"[chip_smoke]   forward 1 x {P12_LONG} (q_chunk {q_chunk}, "
          f"{P12_LONG // q_chunk} chunks): {fwd_ms:.2f} ms, logits {tuple(logits.shape)} "
          f"{logits.dtype}, finite {finite}")
    if q_chunk != 512 or not finite:
        raise AssertionError(f"phase 12: the 4k forward: q_chunk {q_chunk}, finite {finite}")
    del logits

    # prefill 512 tokens at batch 4, then 64 greedy decode steps
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(P12_BATCH, P12_PROMPT))).cuda()
    prefill = make_prefill_step(ad)
    prefill_ms = _ms(torch, lambda: prefill(params, prompt), reps=3, queued=False)
    step_logits, stamps = [], []

    def hook(pos, lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        step_logits.append(lg)

    torch.cuda.synchronize()
    start = time.perf_counter()
    gen = TS.greedy_generate(ad, params, prompt, P12_GEN + 1, step_hook=hook)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - start
    steps_ms = np.diff(stamps) * 1e3
    warm_ms, tok_ms = steps_ms[: P12_PROMPT - 1], steps_ms[P12_PROMPT - 1:]
    print(f"[chip_smoke]   prefill {P12_BATCH} x {P12_PROMPT}: {prefill_ms:.2f} ms; "
          f"greedy_generate ({P12_PROMPT} teacher-forced + {P12_GEN} greedy decode steps, "
          f"positions to {P12_PROMPT + P12_GEN - 1}, the {cfg.pattern[0].window}-slot rings "
          f"wrap): {gen_s:.2f} s; per decode step (host wall, synchronised) teacher-forced "
          f"median {np.median(warm_ms):.2f} ms, greedy median {np.median(tok_ms):.2f} ms "
          f"(min {tok_ms.min():.2f}, max {tok_ms.max():.2f})")

    # teacher-forced decode against forward on the same positions
    seq = torch.cat([prompt, gen[:, :P12_GEN]], dim=1)  # the tokens each decode step fed
    dec = torch.stack(step_logits, dim=1)
    with torch.no_grad():
        full, _ = ad.forward(params, seq)
    scale = float(full.float().abs().max())
    err = float((dec.float() - full.float()).abs().max()) / scale
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    gen_agree = float((gen[:, 1:] == full[:, P12_PROMPT:].argmax(-1)).float().mean())
    print(f"[chip_smoke]   decode vs forward over {seq.shape[1]} positions x {P12_BATCH}: "
          f"max |d| {err:.4g} of max |logit| {scale:.4g} (tol {P12_DECODE_TOL}); greedy "
          f"argmax agreement {agree:.4f} (generated tokens against forward's argmax "
          f"{gen_agree:.4f})")
    if not (np.isfinite(err) and err <= P12_DECODE_TOL):
        raise AssertionError(f"phase 12: gemma3-1b decode differs from forward by {err}")
    del dec, full, step_logits
    # where a step's time goes: one call of each, traced
    cache = ad.init_cache(P12_BATCH, P12_PROMPT + P12_GEN, "cuda")
    with torch.no_grad():
        traced = {
            f"decode step (batch {P12_BATCH})": _device_busy(
                torch, lambda: ad.decode(params, cache, prompt[:, 0], P12_PROMPT)),
            f"prefill {P12_BATCH} x {P12_PROMPT}": _device_busy(
                torch, lambda: prefill(params, prompt)),
            f"forward 1 x {P12_LONG}": _device_busy(torch, lambda: ad.forward(params, long)),
        }
    del cache
    for name, tr in traced.items():
        print(f"[chip_smoke]   traced {name}: {tr['device_ops']} device ops, busy "
              f"{tr['busy_ms']:.2f} ms of {tr['wall_ms']:.2f} ms host wall (idle share "
              f"{tr['idle_share']:.1%})" if tr["device_ops"] else
              f"[chip_smoke]   traced {name}: the trace shows no device activity")
    detail.update(n_params=n_params, forward_4k_ms=fwd_ms, prefill_ms=prefill_ms,
                  generate_s=gen_s, teacher_forced_step_ms=float(np.median(warm_ms)),
                  decode_step_ms=tok_ms.tolist(), decode_vs_forward=err,
                  argmax_agreement=agree, generated_agreement=gen_agree, traced=traced)
    del params, gen, seq, long
    torch.cuda.empty_cache()
    t0 = _phase("lm gemma3-1b FULL forward, prefill, decode", t0)

    # the trainer at full width, in process so that its peak memory is read
    args = TT.build_parser().parse_args(P12_FULL_TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = TT.train_lm(args)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [round(x * 1e3, 2) for x in res["step_s"]]
    losses_ok = np.isfinite(res["first_loss"]) and np.isfinite(res["final_loss"])
    print(f"[chip_smoke]   train {P12_FULL} FULL, batch {args.batch} x {args.seq}: steps "
          f"{step_ms} ms (host wall, loss read back), peak card memory {peak / 2**30:.2f} GiB "
          f"({(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before); "
          f"loss {res['first_loss']:.4f} -> {res['final_loss']:.4f}")
    if not losses_ok or len(step_ms) != args.steps:
        raise AssertionError(f"phase 12: gemma3-1b training: {res['first_loss']}, "
                             f"{res['final_loss']}, {len(step_ms)} steps")
    detail.update(train_step_ms=step_ms, train_peak_bytes=peak, train_held_bytes=held,
                  train_first_loss=res["first_loss"], train_final_loss=res["final_loss"])
    del res
    torch.cuda.empty_cache()
    _phase("lm gemma3-1b FULL train", t0)
    return detail


def _lm_phase(torch, np, K, t0) -> dict:
    """Phase 12 -> its detail.  Raises on the first failed check."""
    import ast
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager

    K.reset_launch_counts()
    detail = {"smoke": _lm_smoke_archs(torch, np, t0)}
    t0 = time.perf_counter()

    # (b) the LM trainer, then its resume
    ckpt = ROOT / P12_CKPT
    shutil.rmtree(ckpt, ignore_errors=True)
    first = _train_losses(_run_cli(
        [sys.executable, "-m", P12_TRAIN, *P12_TRAIN_ARGS, "--steps", str(P12_STEPS)],
        "p12_train", 300))
    committed = CheckpointManager(str(ckpt)).list_steps()
    head, tail = first.get(0, math.nan), [first.get(s, math.nan) for s in range(15, 20)]
    print(f"[chip_smoke]   train --mode lm yi-6b SMOKE, {P12_STEPS} steps: loss {head:.4f} -> "
          f"mean of the last 5 {np.mean(tail):.4f}; committed {committed}")
    if sorted(first) != list(range(P12_STEPS)) or not np.isfinite(list(first.values())).all() \
            or not np.mean(tail) < head or committed != [10, 20]:
        raise AssertionError(f"phase 12: the LM trainer: losses {first}, committed {committed}")
    out = _run_cli(
        [sys.executable, "-m", P12_TRAIN, *P12_TRAIN_ARGS, "--steps", str(P12_RESUME)],
        "p12_train_resume", 300)
    resumed = _train_losses(out)
    committed = CheckpointManager(str(ckpt)).list_steps()
    print(f"[chip_smoke]   resumed: steps {min(resumed, default=None)}-"
          f"{max(resumed, default=None)}, loss {resumed.get(P12_RESUME - 1, math.nan):.4f}; "
          f"committed {committed}")
    if "[train] resumed from step 20" not in out or sorted(resumed) != list(
            range(P12_STEPS, P12_RESUME)) or committed != [20, 30]:
        raise AssertionError(f"phase 12: the resume: {sorted(resumed)}, committed {committed}")
    shutil.rmtree(ckpt, ignore_errors=True)
    detail["train_smoke"] = dict(losses=first, resumed=resumed)
    t0 = _phase("lm train and resume (subprocesses)", t0)

    # (c) the LM server
    out = _run_cli([sys.executable, "-m", P8_SERVER, *P12_SERVE_ARGS], "p12_serve", 300)
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] {")]
    stats = ast.literal_eval(line[-1].removeprefix("[serve] ")) if line else {}
    print(f"[chip_smoke]   serve --mode lm: {stats}")
    if stats.get("requests") != 4 or stats.get("gen_shape") != (16,):
        raise AssertionError(f"phase 12: serve --mode lm: {out[-2000:]}")
    detail["serve"] = stats
    t0 = _phase("lm serve (subprocess)", t0)

    # (d) gemma3-1b at its full width
    detail["full"] = _lm_full(torch, np, t0)
    launches = K.launch_counts()
    print(f"[chip_smoke]   registry kernel launches over phase 12's in-process work: {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 12: a registry kernel ran on the LM path: {launches}")
    detail["launches"] = launches
    return detail


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _phase13(name: str, t0: float) -> float:
    """Phase 13's step line: its wall time and the card it ran on."""
    now = time.perf_counter()
    print(f"[chip_smoke] phase {name}: {now - t0:.1f} s on {_card()}", flush=True)
    return now


def _all_finite(values) -> bool:
    return all(math.isfinite(v) for v in values)


def _hymba_window(torch, np, t0) -> dict:
    """Phase 13 (a): hymba SMOKE decoded past its window, card against CPU
    and against its own forward on the card."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_lm_config
    from repro_torch.launch.steps import get_adapter
    from repro_torch.models.hymba import HYMBA_WINDOW

    cfg = get_lm_config(P13_WINDOW_ARCH, "smoke")
    ad = get_adapter(cfg)
    if P13_WINDOW_LEN <= HYMBA_WINDOW:
        raise AssertionError(f"phase 13: {P13_WINDOW_LEN} tokens do not pass the window")
    toks = torch.from_numpy(np.random.default_rng(131).integers(
        0, cfg.vocab_size, size=(1, P13_WINDOW_LEN)))
    cpu_params = ad.init(torch.Generator().manual_seed(0), "cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        x = toks.to(dev)
        with torch.no_grad():
            full, _ = ad.forward(params, x)
            cache, steps = ad.init_cache(1, P13_WINDOW_LEN, dev), []
            start = time.perf_counter()
            for pos in range(P13_WINDOW_LEN):
                lg, cache = ad.decode(params, cache, x[:, pos], pos)
                steps.append(lg)
            dec = torch.stack(steps, 1)
            if dev == "cuda":
                torch.cuda.synchronize()
            dec_s = time.perf_counter() - start
        res[dev] = (full.float().cpu(), dec.float().cpu(), dec_s, cache.kv.k.shape[2])
    (fc, dc, _, _), (fg, dg, dec_s, ring) = res["cpu"], res["cuda"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
    errs = dict(decode_vs_cpu=rel(dg, dc), forward_vs_cpu=rel(fg, fc),
                decode_vs_forward=rel(dg, fg), last16_decode_vs_forward=rel(dg[:, -16:],
                                                                            fg[:, -16:]))
    print(f"[chip_smoke]   {P13_WINDOW_ARCH} SMOKE over 1 x {P13_WINDOW_LEN} ({ring}-slot ring, "
          f"window {HYMBA_WINDOW}): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {P13_TOL}); {P13_WINDOW_LEN} decode steps on the card in {dec_s:.2f} s")
    if ring != HYMBA_WINDOW or not all(np.isfinite(v) and v <= P13_TOL for v in errs.values()):
        raise AssertionError(f"phase 13: hymba past its window: ring {ring}, {errs}")
    _phase13("lm hymba SMOKE past the window", t0)
    return dict(errs, decode_s=dec_s, ring=ring)


def _recurrent_cli(t0) -> dict:
    """Phase 13 (b): hymba's trainer with a resume, xlstm's server."""
    import ast
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager

    ckpt = ROOT / P13_CKPT
    shutil.rmtree(ckpt, ignore_errors=True)
    first = _train_losses(_run_cli(
        [sys.executable, "-m", P12_TRAIN, *P13_TRAIN_ARGS, "--steps", str(P13_STEPS)],
        "p13_train", 300))
    committed = CheckpointManager(str(ckpt)).list_steps()
    print(f"[chip_smoke]   train --mode lm hymba-1.5b SMOKE, {P13_STEPS} steps: losses "
          f"{[round(first[k], 4) for k in sorted(first)]}; committed {committed}")
    if sorted(first) != list(range(P13_STEPS)) or not _all_finite(first.values()) \
            or committed != [2, 4]:
        raise AssertionError(f"phase 13: the hymba trainer: losses {first}, committed {committed}")
    out = _run_cli([sys.executable, "-m", P12_TRAIN, *P13_TRAIN_ARGS, "--steps", str(P13_RESUME)],
                   "p13_train_resume", 300)
    resumed = _train_losses(out)
    committed = CheckpointManager(str(ckpt)).list_steps()
    print(f"[chip_smoke]   resumed: steps {sorted(resumed)}; committed {committed}")
    if f"[train] resumed from step {P13_STEPS}" not in out or sorted(resumed) != list(
            range(P13_STEPS, P13_RESUME)) or committed != [4, 6]:
        raise AssertionError(f"phase 13: the resume: {sorted(resumed)}, committed {committed}")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = _phase13("lm hymba train and resume (subprocesses)", t0)

    out = _run_cli([sys.executable, "-m", P8_SERVER, *P13_SERVE_ARGS], "p13_serve", 300)
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] {")]
    stats = ast.literal_eval(line[-1].removeprefix("[serve] ")) if line else {}
    print(f"[chip_smoke]   serve --mode lm --arch xlstm-350m: {stats}")
    if stats.get("requests") != 4 or stats.get("gen_shape") != (16,):
        raise AssertionError(f"phase 13: serve --mode lm xlstm: {out[-2000:]}")
    _phase13("lm xlstm serve (subprocess)", t0)
    return dict(train_losses=first, resumed=resumed, serve=stats)


def _recurrent_f32(torch, cfg, params, seq) -> dict:
    """Phase 13 (c)'s gate: the bf16 weights upcast to float32, teacher-forced
    decode over ``seq`` against the forward (and, for xlstm, the forward in
    chunks of ``P13_CARRY_CHUNK`` against one chunk), relative to max |logit|."""
    from repro_torch.common.tree import tree_map
    from repro_torch.launch.steps import get_adapter
    from repro_torch.models.xlstm import xlstm_forward

    cfg = dataclasses.replace(cfg, dtype="float32")
    ad = get_adapter(cfg)
    params = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        full, _ = ad.forward(params, seq)
        cache, steps = ad.init_cache(seq.shape[0], seq.shape[1], "cuda"), []
        for pos in range(seq.shape[1]):
            lg, cache = ad.decode(params, cache, seq[:, pos], pos)
            steps.append(lg)
        scale = float(full.abs().max())
        out = dict(decode_vs_forward=float((torch.stack(steps, 1) - full).abs().max()) / scale,
                   chunk_carry=None)
        if cfg.family == "ssm":
            chunked, _ = xlstm_forward(cfg, params, seq, chunk_size=P13_CARRY_CHUNK)
            out["chunk_carry"] = float((chunked - full).abs().max()) / scale
    return out


def _recurrent_full(torch, np, arch: str, t0) -> dict:
    """Phase 13 (c): one recurrent arch at its full width from a random init."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_lm_config
    from repro_torch.launch import serve as TS
    from repro_torch.launch import train as TT
    from repro_torch.launch.steps import get_adapter, make_prefill_step

    long_len, train_b, train_s = P13_FULL[arch]
    cfg = get_lm_config(arch, "full")
    ad = get_adapter(cfg)
    torch.cuda.empty_cache()
    start = time.perf_counter()
    params = ad.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[chip_smoke]   {arch} FULL: {n_params / 1e9:.4f} B parameters (param_count "
          f"{cfg.param_count() / 1e9:.4f} B), {cfg.dtype}, d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, vocab {cfg.vocab_size}; init {time.perf_counter() - start:.1f} s")
    if {p.dtype for p in tree_leaves(params)} != {torch.bfloat16, torch.float32}:
        raise AssertionError(f"phase 13: {arch} FULL is not bf16 with float32 gates and norms")
    rng = np.random.default_rng(133)

    long = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, long_len))).cuda()
    with torch.no_grad():
        ad.forward(params, long[:, :256])  # warm: the first call's set-up stays out
        torch.cuda.synchronize()
        start = time.perf_counter()
        logits, _ = ad.forward(params, long)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - start) * 1e3
    finite = bool(torch.isfinite(logits).all())
    print(f"[chip_smoke]   forward 1 x {long_len} (host wall, synchronised, one call): "
          f"{fwd_ms:.2f} ms, logits {tuple(logits.shape)} {logits.dtype}, finite {finite}")
    if not finite:
        raise AssertionError(f"phase 13: {arch}'s long forward is not finite")
    del logits

    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(P12_BATCH, P12_PROMPT))).cuda()
    prefill = make_prefill_step(ad)
    prefill_ms = _ms(torch, lambda: prefill(params, prompt), reps=1, queued=False)
    prompt = prompt[:, :P13_PROMPT]
    step_logits, stamps = [], []

    def hook(pos, lg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        step_logits.append(lg)

    torch.cuda.synchronize()
    start = time.perf_counter()
    gen = TS.greedy_generate(ad, params, prompt, P12_GEN + 1, step_hook=hook)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - start
    steps_ms = np.diff(stamps) * 1e3
    warm_ms, tok_ms = steps_ms[: P13_PROMPT - 1], steps_ms[P13_PROMPT - 1:]
    print(f"[chip_smoke]   prefill {P12_BATCH} x {P12_PROMPT}: {prefill_ms:.2f} ms; "
          f"greedy_generate ({P13_PROMPT} teacher-forced + {P12_GEN} greedy decode steps): "
          f"{gen_s:.2f} s; per decode step (host wall, synchronised) teacher-forced median "
          f"{np.median(warm_ms):.2f} ms, greedy median {np.median(tok_ms):.2f} ms "
          f"(min {tok_ms.min():.2f}, max {tok_ms.max():.2f})")

    seq = torch.cat([prompt, gen[:, :P12_GEN]], dim=1)
    dec = torch.stack(step_logits, dim=1)
    with torch.no_grad():
        full, _ = ad.forward(params, seq)
    scale = float(full.float().abs().max())
    err = float((dec.float() - full.float()).abs().max()) / scale
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    gen_agree = float((gen[:, 1:] == full[:, P13_PROMPT:].argmax(-1)).float().mean())
    print(f"[chip_smoke]   bf16 decode vs forward over {seq.shape[1]} positions x {P12_BATCH}: "
          f"max |d| {err:.4g} of max |logit| {scale:.4g} (no gate: see P13_F32_TOL); argmax "
          f"agreement {agree:.4f} (generated tokens against forward's argmax {gen_agree:.4f})")
    if not np.isfinite(err):
        raise AssertionError(f"phase 13: {arch}'s bf16 decode or forward is not finite")
    f32 = _recurrent_f32(torch, cfg, params, seq[:, :P13_PROMPT])
    print(f"[chip_smoke]   float32 (the weights upcast) decode vs forward over {P13_PROMPT} "
          f"positions x {P12_BATCH}: max |d| {f32['decode_vs_forward']:.4g} of max |logit|"
          + (f"; forward in chunks of {P13_CARRY_CHUNK} vs one chunk: {f32['chunk_carry']:.4g}"
             if cfg.family == "ssm" else "") + f" (tol {P13_F32_TOL})")
    if not all(v is None or (np.isfinite(v) and v <= P13_F32_TOL) for v in f32.values()):
        raise AssertionError(f"phase 13: {arch} in float32: {f32}")
    del dec, full, step_logits
    cache = ad.init_cache(P12_BATCH, P13_PROMPT + P12_GEN, "cuda")
    with torch.no_grad():
        traced = _device_busy(torch, lambda: ad.decode(params, cache, prompt[:, 0], P13_PROMPT))
    del cache
    print(f"[chip_smoke]   traced decode step (batch {P12_BATCH}): {traced['device_ops']} device "
          f"ops, busy {traced['busy_ms']:.2f} ms of {traced['wall_ms']:.2f} ms host wall (idle "
          f"share {traced['idle_share']:.1%})" if traced["device_ops"] else
          "[chip_smoke]   traced decode step: the trace shows no device activity")
    detail = dict(n_params=n_params, forward_ms=fwd_ms, forward_len=long_len,
                  prefill_ms=prefill_ms, generate_s=gen_s,
                  teacher_forced_step_ms=float(np.median(warm_ms)),
                  decode_step_ms=tok_ms.tolist(), decode_vs_forward_bf16=err, f32=f32,
                  argmax_agreement=agree, generated_agreement=gen_agree, traced=traced)
    del params, gen, seq, long, prompt
    torch.cuda.empty_cache()
    t0 = _phase13(f"lm {arch} FULL forward, prefill, decode", t0)

    args = TT.build_parser().parse_args(
        ["--mode", "lm", "--arch", arch, "--variant", "full", "--batch", str(train_b),
         "--seq", str(train_s), "--steps", str(P13_TRAIN_STEPS[arch]), "--log-every", "1",
         "--no-sigterm"])
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    res = TT.train_lm(args)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [round(x * 1e3, 2) for x in res["step_s"]]
    print(f"[chip_smoke]   train {arch} FULL, batch {train_b} x {train_s}: steps {step_ms} ms "
          f"(host wall, loss read back), peak card memory {peak / 2**30:.2f} GiB "
          f"({(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before); "
          f"loss {res['first_loss']:.4f} -> {res['final_loss']:.4f}")
    if not _all_finite([res["first_loss"], res["final_loss"]]) or len(step_ms) != args.steps:
        raise AssertionError(f"phase 13: {arch} training: {res['first_loss']}, "
                             f"{res['final_loss']}, {len(step_ms)} steps")
    detail.update(train_step_ms=step_ms, train_peak_bytes=peak, train_held_bytes=held,
                  train_batch=[train_b, train_s], train_first_loss=res["first_loss"],
                  train_final_loss=res["final_loss"])
    del res
    torch.cuda.empty_cache()
    _phase13(f"lm {arch} FULL train", t0)
    return detail


def _skip_full(torch, np, t0) -> dict:
    """Phase 13 (d): layer skipping on gemma3-1b at its full width."""
    from repro_torch.configs import get_lm_config
    from repro_torch.core import lm_skip as LS
    from repro_torch.models import transformer as T

    cfg = get_lm_config(P13_SKIP_ARCH, "full")
    n_units, n_tail = T._pattern_split(cfg)
    params = T.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    toks = torch.from_numpy(np.random.default_rng(134).integers(
        0, cfg.vocab_size, size=(P13_SKIP_BATCH, P13_SKIP_TOKENS))).cuda()

    def timed(step):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - start) * 1e3

    exact, exact_ms = [], []
    cache = T.init_cache(cfg, P13_SKIP_BATCH, P13_SKIP_TOKENS, "cuda")
    with torch.no_grad():
        for pos in range(P13_SKIP_TOKENS):
            (lg, cache), ms = timed(lambda: T.lm_decode(cfg, params, cache, toks[:, pos], pos))
            exact.append(lg.float())
            exact_ms.append(ms)
    del cache
    detail = dict(arch=P13_SKIP_ARCH, units=n_units, tail=n_tail,
                  exact_step_ms=float(np.median(exact_ms[1:])), plans={})
    print(f"[chip_smoke]   {P13_SKIP_ARCH} FULL ({n_units} units of {len(cfg.pattern)} + "
          f"{n_tail} tail), {P13_SKIP_TOKENS} tokens at batch {P13_SKIP_BATCH}: exact lm_decode "
          f"median {detail['exact_step_ms']:.2f} ms a step")
    for plan_args in P13_SKIP_PLANS:
        plan = LS.SkipPlan(*plan_args)
        state = LS.init_skip_state(cfg, P13_SKIP_BATCH, P13_SKIP_TOKENS, "cuda")
        ms_by, cos, first_err, finite = {"FULL": [], "SKIP": []}, [], None, True
        with torch.no_grad():
            for pos in range(P13_SKIP_TOKENS):
                (lg, state), ms = timed(lambda: LS.skip_decode(
                    cfg, params, state, toks[:, pos], pos, plan))
                kind = "FULL" if pos % plan.refresh_every == 0 else "SKIP"
                if pos:
                    ms_by[kind].append(ms)
                lg = lg.float()
                finite = finite and bool(torch.isfinite(lg).all())
                cos.append(float(torch.nn.functional.cosine_similarity(
                    lg.reshape(-1), exact[pos].reshape(-1), dim=0)))
                if pos == 0:
                    first_err = float((lg - exact[0]).abs().max() / exact[0].abs().max())
        del state
        skip_cos = [c for p, c in enumerate(cos) if p % plan.refresh_every]
        red = LS.flops_reduction(cfg, plan)
        row = dict(full_step_ms=float(np.median(ms_by["FULL"])),
                   skip_step_ms=float(np.median(ms_by["SKIP"])),
                   cos_mean=float(np.mean(cos)), cos_skip_mean=float(np.mean(skip_cos)),
                   cos_skip_min=float(np.min(skip_cos)), first_step_err=first_err,
                   flops_reduction=red)
        detail["plans"][str(plan_args)] = row
        print(f"[chip_smoke]   skip_decode SkipPlan{plan_args}: FULL step median "
              f"{row['full_step_ms']:.2f} ms, SKIP step median {row['skip_step_ms']:.2f} ms "
              f"(host wall, synchronised); logit cosine vs exact decode mean {row['cos_mean']:.4f}"
              f", over SKIP steps mean {row['cos_skip_mean']:.4f} min {row['cos_skip_min']:.4f}; "
              f"first (FULL) step vs exact {first_err:.3g}; flops_reduction {red:.4f}")
        if not finite or not first_err <= P13_SKIP_TOL or not _all_finite(cos):
            raise AssertionError(f"phase 13: skip_decode {plan_args}: finite {finite}, "
                                 f"first step {first_err}, cosines {cos}")
    del params, exact
    torch.cuda.empty_cache()
    _phase13(f"lm skip_decode {P13_SKIP_ARCH} FULL", t0)
    return detail


def _recurrent_phase(torch, np, K, t0) -> dict:
    """Phase 13 -> its detail.  Raises on the first failed check."""
    K.reset_launch_counts()
    detail = {"window": _hymba_window(torch, np, t0)}
    detail["cli"] = _recurrent_cli(time.perf_counter())
    for arch in P13_FULL:
        detail[arch] = _recurrent_full(torch, np, arch, time.perf_counter())
    detail["skip"] = _skip_full(torch, np, time.perf_counter())
    launches = K.launch_counts()
    print(f"[chip_smoke]   registry kernel launches over phase 13's in-process work: {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 13: a registry kernel ran on the LM path: {launches}")
    detail["launches"] = launches
    _phase13("lm recurrent families and layer skipping", t0)
    return detail


def _dryrun_sweeps(torch, t0) -> dict:
    """Phase 14 (a): the three sweeps as subprocesses, then one line a cell."""
    import os
    import shutil

    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    total = torch.cuda.get_device_properties(0).total_memory
    jobs = -(-(os.cpu_count() or 1) // len(P14_SWEEPS))  # every core busy
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {}
    try:
        for name, flags in P14_SWEEPS.items():
            out = ROOT / "build" / f"p14_{name.replace(' ', '_')}"
            shutil.rmtree(out, ignore_errors=True)
            tag = f"p14_dryrun_{name.replace(' ', '_')}"
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", P14_DRYRUN, *flags, "--jobs", str(jobs), "--out", str(out)],
                cwd=ROOT, env=env, stdout=open(logs / f"{tag}.out", "w"),
                stderr=open(logs / f"{tag}.err", "w")), out, tag)
        codes = {name: p.wait(timeout=P14_WAIT_S) for name, (p, _, _) in procs.items()}
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"[chip_smoke]   dry-run sweeps ({jobs} jobs each): exit codes {codes}; card "
          f"total_memory {total} B ({total / 2**30:.2f} GiB), HBM_BYTES "
          f"{_mesh_constants()['HBM_BYTES']} B")
    if any(codes.values()):
        raise AssertionError(f"phase 14: a dry-run sweep failed: {codes}")
    detail = {}
    for name, (_, out, tag) in procs.items():
        cells = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
        if len(cells) != P14_CELLS or not all(c["ok"] for c in cells):
            raise AssertionError(f"phase 14: sweep {name}: {len(cells)} cells, "
                                 f"{sum(c['ok'] for c in cells)} ok")
        keep = []
        for c in cells:
            mem, roof = c["memory"], c["roofline_s"]
            fits = "fits" if mem["peak_bytes"] <= total else "DOES NOT FIT"
            cost = ("no cost pass (skipped)" if c["cost_mode"] == "skipped" else
                    f"compute {roof['compute']:.4g} s, memory {roof['memory']:.4g} s, "
                    f"collective {roof['collective']:.4g} s: {c['bottleneck']} "
                    f"({c['cost_mode']})")
            print(f"[chip_smoke]   {name} {c['arch']}/{c['cell']}: args "
                  f"{mem['argument_bytes'] / 2**30:.3f} GiB, peak "
                  f"{mem['peak_bytes'] / 2**30:.2f} GiB of {total / 2**30:.2f} ({fits}); {cost}")
            keep.append({k: c[k] for k in ("arch", "cell", "mesh", "cost_mode", "memory",
                                           "roofline_s", "bottleneck", "collectives",
                                           "flops_per_device", "bytes_per_device")})
        detail[name] = keep
        shutil.rmtree(out, ignore_errors=True)
    _phase13("mesh costing sweeps (subprocesses)", t0)
    return detail


def _mesh_constants() -> dict:
    from repro_torch.launch import mesh

    return {k: getattr(mesh, k) for k in ("HBM_BYTES", "PEAK_FLOPS_BF16", "HBM_BW", "LINK_BW")}


def _card_args(torch, spec, cfg, cell):
    """``spec``'s args on the card: the adapter's init (random, from a seed),
    AdamW's state, random tokens, a zero cache; the decode position as a
    0-d int32 tensor (the reference's traced scalar)."""
    from repro_torch.launch.steps import get_adapter
    from repro_torch.optim import init_adamw

    gen = torch.Generator(device="cuda").manual_seed(0)
    adapter = get_adapter(cfg)
    params = adapter.init(gen, "cuda")
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda",
                               dtype=torch.int32)
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda",
                               dtype=torch.int32)
        return (params, init_adamw(params), {"inputs": tokens, "labels": labels})
    token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda",
                          dtype=torch.int32)
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    return (params, adapter.init_cache(b, s, "cuda"), token, pos)


def _dryrun_held(torch, card, t0) -> dict:
    """Phase 14 (b): each P14_FULL arch's cells costed at make_host_mesh()
    (whole depth) and run on the card: argument bytes against the
    allocator's rise, FLOPs against FlopCounterMode's, temp bytes against
    the peak's rise, step time against the roofline."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common.types import ShapeCell
    from repro_torch.configs import get_lm_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import input_specs

    mesh = make_host_mesh()
    detail = {}
    for arch in P14_FULL:
        cfg = get_lm_config(arch, "full")
        for shape in P14_SHAPES:
            cell = ShapeCell(*shape)
            t_cost = time.perf_counter()
            res = D.cost_cell(cfg, cell, mesh)
            t_cost = time.perf_counter() - t_cost
            spec = input_specs(cfg, cell, mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            args = _card_args(torch, spec, cfg, cell)
            torch.cuda.synchronize()
            rise = torch.cuda.memory_allocated() - before
            run = D._run_args(dataclasses.replace(spec, args=args), cell)
            want = res["memory"]["argument_bytes"]
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with FlopCounterMode(display=False) as fc:
                out = spec.step_fn(*run)
            torch.cuda.synchronize()
            temp = torch.cuda.max_memory_allocated() - held
            del out
            step_ms = []
            for _ in range(P14_STEPS):
                t = time.perf_counter()
                out = spec.step_fn(*run)
                torch.cuda.synchronize()
                step_ms.append(round((time.perf_counter() - t) * 1e3, 2))
                del out
            roof = res["roofline_s"]
            bound_ms = max(roof["compute"], roof["memory"]) * 1e3
            flops = fc.get_total_flops()
            row = dict(args_predicted=want, args_allocated=rise,
                       args_err=abs(rise - want) / want, flops_predicted=res["flops_per_device"],
                       flops_card=flops, temp_predicted=res["memory"]["temp_bytes"],
                       temp_card=temp, step_ms=step_ms, roofline_ms=bound_ms,
                       roofline_share=bound_ms / min(step_ms), bottleneck=res["bottleneck"],
                       cost_s=round(t_cost, 2), card=card)
            detail[f"{arch}/{cell.name}"] = row
            print(f"[chip_smoke]   {arch} FULL {cell.name} ({cell.global_batch} x "
                  f"{cell.seq_len}), host mesh: args predicted {want} B, allocated {rise} B "
                  f"({row['args_err']:.3%}); FLOPs predicted {res['flops_per_device']:.6g}, "
                  f"FlopCounterMode on the card {flops:.6g}; temp predicted "
                  f"{row['temp_predicted'] / 2**30:.2f} GiB, max_memory_allocated rise "
                  f"{temp / 2**30:.2f} GiB; steps {step_ms} ms against the roofline's "
                  f"{bound_ms:.3f} ms ({row['roofline_share']:.1%} of it, {res['bottleneck']}); "
                  f"costed in {t_cost:.1f} s; {card}")
            del args, run
            torch.cuda.empty_cache()
            if not row["args_err"] <= P14_ARG_TOL:
                raise AssertionError(f"phase 14: {arch} {cell.name}: argument bytes predicted "
                                     f"{want}, allocated {rise}")
            if float(flops) != res["flops_per_device"]:
                raise AssertionError(f"phase 14: {arch} {cell.name}: FLOPs predicted "
                                     f"{res['flops_per_device']}, counted on the card {flops}")
    _phase13("mesh costing held against the card", t0)
    return detail


def _dryrun_phase(torch, K, card, t0) -> dict:
    """Phase 14 -> its detail.  Raises on the first failed check."""
    K.reset_launch_counts()
    detail = {"sweeps": _dryrun_sweeps(torch, time.perf_counter())}
    detail["held"] = _dryrun_held(torch, card, time.perf_counter())
    launches = K.launch_counts()
    print(f"[chip_smoke]   registry kernel launches over phase 14's in-process work: {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 14: a registry kernel ran on the LM path: {launches}")
    detail["launches"] = launches
    _phase13("mesh costing", t0)
    return detail


def _p15_rank(device, jobs):
    """One rank of phase 15's worlds: ``train_on_mesh``, with the rank's
    registry launch counts (a kernel on the LM path fails the phase)."""
    from repro_torch import kernels as K
    from repro_torch.launch import distributed as D

    results = D.train_on_mesh(device, jobs)
    for r in results:
        r["launches"] = K.launch_counts()
    return results


def _rounded(d: dict) -> dict:
    return {k: round(v, 2) for k, v in d.items()}


def _p15_launches(where: str, ranks: list) -> None:
    launched = {k: v for r in ranks for res in r for k, v in res["launches"].items() if v}
    if launched:
        raise AssertionError(f"phase 15 {where}: a registry kernel ran on the LM path: {launched}")


def _p15_single(torch, arch, variant, device, steps, remat) -> list[float]:
    """The single-process step's losses from the ranks' weights (the init
    from seed 0 on the CPU's generator) on the ranks' batches."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import get_lm_config
    from repro_torch.data.pipeline import DataConfig, token_batch
    from repro_torch.launch.distributed import MeshJob
    from repro_torch.launch.steps import get_adapter, make_train_step
    from repro_torch.optim import init_adamw

    cfg = get_lm_config(arch, variant)
    adapter = get_adapter(cfg)
    params = tree_map(lambda x: x.to(device),
                      adapter.init(torch.Generator().manual_seed(0), "cpu"))
    opt = init_adamw(params)
    step = make_train_step(adapter, MeshJob.opt, remat=remat)
    dc = DataConfig(global_batch=P15_BATCH, seq_len=P15_SEQ, vocab_size=cfg.vocab_size)
    losses = []
    for s in range(steps):
        nb = token_batch(dc, s)
        batch = {"inputs": torch.from_numpy(nb["tokens"]).to(device),
                 "labels": torch.from_numpy(nb["labels"]).to(device)}
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    del params, opt
    return losses


def _example_phase(card, t0) -> dict:
    """Phase 15 (a): the example on the card and on CPU ranks, started
    together (sooner done, on an 8-core H100 host, than one after the
    other)."""
    import os
    import re
    import shutil

    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs, files = {}, []
    try:
        for dev in ("cuda", "cpu"):
            ckpt = ROOT / "build" / f"p15_example_ckpt_{dev}"
            shutil.rmtree(ckpt, ignore_errors=True)
            files += [open(logs / f"p15_example_{dev}.{ext}", "w") for ext in ("out", "err")]
            procs[dev] = subprocess.Popen(
                [sys.executable, P15_EXAMPLE, *(["--device", "cpu"] if dev == "cpu" else []),
                 "--ckpt-dir", str(ckpt)], cwd=ROOT, env=env, stdout=files[-2], stderr=files[-1])
        codes, wall, t_start = {}, {}, time.perf_counter()
        while len(codes) < len(procs):
            for dev, p in procs.items():
                if dev not in codes and p.poll() is not None:
                    codes[dev], wall[dev] = p.returncode, time.perf_counter() - t_start
            if time.perf_counter() - t_start > P15_WAIT_S:
                raise AssertionError(f"phase 15 (a): the example ran past {P15_WAIT_S} s")
            time.sleep(0.2)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
        for dev in procs:
            shutil.rmtree(ROOT / "build" / f"p15_example_ckpt_{dev}", ignore_errors=True)
    if any(codes.values()):
        raise AssertionError(f"phase 15 (a): the example exited {codes}; see "
                             "chiprun_out/p15_example_*.err")
    outs = {dev: (logs / f"p15_example_{dev}.out").read_text() for dev in procs}
    losses = {dev: [float(v) for v in re.findall(r"step \d+: loss=(\S+)", out)]
              for dev, out in outs.items()}
    if any(len(v) != 9 for v in losses.values()):
        raise AssertionError(f"phase 15 (a): losses {losses}")
    errs = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    print(f"[chip_smoke]   example on the card: {outs['cuda'].splitlines()[0]} | "
          f"{outs['cuda'].splitlines()[-1]}; wall s (started together) {_rounded(wall)}; "
          f"{card}")
    print(f"[chip_smoke]   example losses, card {losses['cuda']} against CPU ranks "
          f"{losses['cpu']}: max relative {max(errs):.3g} (tol {P15_EXAMPLE_TOL}); {card}")
    if not max(errs) <= P15_EXAMPLE_TOL:
        raise AssertionError(f"phase 15 (a): card and CPU losses differ by {max(errs)}")
    _phase13("distributed example (card and CPU ranks)", t0)
    return dict(losses=losses, max_rel_err=max(errs), wall_s=wall,
                first_line=outs["cuda"].splitlines()[0])


def _mesh_full(torch, card, mesh, backend, t0, save=None, restart=None, also=()) -> dict:
    """Phase 15 (b) / (d): gemma3-1b FULL on ``mesh`` over ``backend``'s
    ranks against the single-process step on the card; ``restart`` = (the
    new mesh, its backend, the plan's global batch) restores ``save`` onto
    a second world; the jobs ``also`` run in the same world after it (one
    spawn fewer), their rank-0 results under ``"also"``."""
    from repro_torch.common.sharding import tree_shard_bytes
    from repro_torch.common.types import Mesh, ShapeCell
    from repro_torch.configs import get_lm_config
    from repro_torch.launch import distributed as D
    from repro_torch.launch.dryrun import collectives_from_specs
    from repro_torch.launch.specs import params_struct
    from repro_torch.launch.steps import get_adapter, opt_pspecs
    from repro_torch.optim import init_adamw

    t = time.perf_counter()
    want = _p15_single(torch, P15_FULL_ARCH, "full", "cuda", P15_FULL_STEPS, remat=True)
    single_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    job = D.MeshJob(P15_FULL_ARCH, mesh, (0, P15_FULL_STEPS), P15_BATCH, seq_len=P15_SEQ,
                    variant="full", remat=True, save=save)
    t = time.perf_counter()
    ranks = D.run_ranks(_p15_rank, ([job, *also],), backend, str(ROOT / P15_RENDEZVOUS),
                        P15_WAIT_S)
    world_s = time.perf_counter() - t
    _p15_launches(f"{mesh}", ranks)
    res = [r[0] for r in ranks]
    losses = res[0]["losses"]
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    step_s = [max(r["step_s"][i] for r in res) for i in range(P15_FULL_STEPS)]
    cfg = get_lm_config(P15_FULL_ARCH, "full")
    adapter = get_adapter(cfg)
    specs = adapter.pspecs(mesh[1])
    m = Mesh(mesh, ("data", "model"))
    meta = params_struct(adapter)
    resident = (tree_shard_bytes(m, specs, meta)
                + tree_shard_bytes(m, opt_pspecs(specs), init_adamw(meta)))
    model = collectives_from_specs(cfg, ShapeCell("p15", P15_SEQ - 1, P15_BATCH, "train"), m,
                                   specs)
    counted: dict[str, int] = {}
    for (kind, _, _), n in res[0]["counts"].items():
        counted[kind] = counted.get(kind, 0) + n
    print(f"[chip_smoke]   gemma3-1b FULL {mesh} over {len(res)} ranks, {backend.describe}: "
          f"{D.n_params(P15_FULL_ARCH, 'full') / 1e9:.3f} B params; world {world_s:.1f} s "
          f"(spawn, init, {P15_FULL_STEPS} steps{', then (c)' if also else ''}); {card}")
    print(f"[chip_smoke]   losses {losses} against the single-process step's {want} "
          f"({single_s:.1f} s): max relative {max(errs):.3g} (tol {P15_FULL_TOL}, headroom "
          f"{P15_FULL_TOL / max(max(errs), 1e-12):.1f}x); step s (slowest rank) "
          f"{[round(v, 3) for v in step_s]}; {card}")
    for r in res:
        req, rise = r["requested_rise"], r["allocated_rise"]
        print(f"[chip_smoke]   rank {r['coords']} on {r['device']}: resident "
              f"{r['param_bytes'] + r['opt_bytes']} B (tree_shard_bytes {resident}), requested "
              f"from the allocator {req} B ({abs(req - resident) / resident:.3%}), its blocks "
              f"{rise} B (+{(rise - resident) / resident:.3%}: each request rounded up to its "
              f"block), peak {r['peak'] / 2**30:.2f} GiB; placed in {r['setup_s']:.1f} s; last "
              f"step's staged seconds {_rounded(r['staged_s'])}; {card}")
    print(f"[chip_smoke]   collective bytes a rank, one step: counted {counted} against "
          f"collectives_from_specs {model}; staged through the host "
          f"{res[0]['staged_bytes']}; {card}")
    row = dict(mesh=mesh, backend=backend.describe, losses=losses, single=want, rel_err=errs,
               step_s=step_s, world_s=world_s, resident=resident, counted=counted,
               counts={"|".join(k): v for k, v in res[0]["counts"].items()}, model=model,
               staged=res[0]["staged_bytes"],
               ranks=[{k: r[k] for k in ("coords", "device", "param_bytes", "opt_bytes",
                                        "requested_rise", "allocated_rise", "peak", "step_s",
                                        "setup_s", "staged_s")} for r in res],
               also=ranks[0][1:])
    if not max(errs) <= P15_FULL_TOL:
        raise AssertionError(f"phase 15 {mesh}: losses {losses} against {want}")
    for r in res:
        if r["param_bytes"] + r["opt_bytes"] != resident:
            raise AssertionError(f"phase 15 {mesh}: rank {r['coords']} holds "
                                 f"{r['param_bytes'] + r['opt_bytes']} B, not {resident}")
        if not abs(r["requested_rise"] - resident) <= P15_ARG_TOL * resident:
            raise AssertionError(f"phase 15 {mesh}: rank {r['coords']} asked the allocator for "
                                 f"{r['requested_rise']} B for {resident}")
    if restart is not None:
        new_mesh, new_backend, batch = restart
        job = D.MeshJob(P15_FULL_ARCH, new_mesh, (P15_FULL_STEPS, P15_FULL_STEPS + 2), batch,
                        seq_len=P15_SEQ, variant="full", restore=save)
        ranks = D.run_ranks(_p15_rank, ([job],), new_backend, str(ROOT / P15_RENDEZVOUS),
                            P15_WAIT_S)
        _p15_launches(f"{new_mesh}", ranks)
        row["restart"] = dict(mesh=new_mesh, backend=new_backend.describe,
                              losses=ranks[0][0]["losses"])
        print(f"[chip_smoke]   elastic restart onto {new_mesh}, {new_backend.describe}: "
              f"losses {ranks[0][0]['losses']}; {card}")
        if not _all_finite(ranks[0][0]["losses"]):
            raise AssertionError(f"phase 15: the restart's losses {ranks[0][0]['losses']}")
    _phase13(f"distributed gemma3-1b FULL {mesh}", t0)
    return row


def _moe_check(torch, card, results) -> dict:
    """Phase 15 (c): the MoE archs' losses at (4, 2) on the card (rank 0's
    results, in P15_MOE's order) against the single-process step on the
    CPU."""
    detail = {}
    for arch, res in zip(P15_MOE, results):
        got = res["losses"]
        want = _p15_single(torch, arch, "smoke", "cpu", P15_MOE_STEPS, remat=False)
        err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        detail[arch] = dict(card=got, cpu=want, rel_err=err)
        print(f"[chip_smoke]   {arch} SMOKE (4, 2) on the card {got} against the CPU's "
              f"single-process step {want}: max relative {err:.3g} (tol {P15_MOE_TOL}); {card}")
        if not err <= P15_MOE_TOL:
            raise AssertionError(f"phase 15 (c): {arch} card {got}, CPU {want}")
    return detail


def _nccl_phase(torch, card, t0) -> dict:
    """Phase 15 (d), on 4 cards or more: (b) at P15_NCCL_MESH on nccl, a card
    a rank, checkpointed, then restarted onto the elastic plan's mesh."""
    import shutil

    from repro_torch.launch import distributed as D
    from repro_torch.runtime.fault_tolerance import ElasticPlan

    plan = ElasticPlan.plan(*P15_NCCL_MESH, failed=1, global_batch=P15_BATCH)
    new = (plan.new_data, plan.new_model)
    ckpt = ROOT / "build" / "p15_nccl_ckpt"
    try:
        return _mesh_full(
            torch, card, P15_NCCL_MESH, D.choose_backend("cuda", math.prod(P15_NCCL_MESH)), t0,
            save=str(ckpt),
            restart=(new, D.choose_backend("cuda", math.prod(new)), plan.new_global_batch))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _distributed_phase(torch, K, card, t0) -> dict:
    """Phase 15 -> its detail.  Raises on the first failed check."""
    from repro_torch.launch import distributed as D

    K.reset_launch_counts()
    detail = {"example": _example_phase(card, time.perf_counter())}
    backend = D.choose_backend("cuda", math.prod(P15_FULL_MESH))
    print(f"[chip_smoke]   backend for {P15_FULL_MESH}: {backend.describe}; {card}")
    moe = [D.MeshJob(a, P15_FULL_MESH, (0, P15_MOE_STEPS), P15_BATCH, seq_len=P15_SEQ)
           for a in P15_MOE]
    detail["full"] = _mesh_full(torch, card, P15_FULL_MESH, backend, time.perf_counter(),
                                also=moe)
    detail["moe"] = _moe_check(torch, card, detail["full"].pop("also"))
    if torch.cuda.device_count() >= P15_NCCL_MESH[0] * P15_NCCL_MESH[1]:
        detail["nccl"] = _nccl_phase(torch, card, time.perf_counter())
    launches = K.launch_counts()
    print(f"[chip_smoke]   registry kernel launches over phase 15's in-process work: {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 15: a registry kernel ran on the LM path: {launches}")
    _phase13("distributed train", t0)
    return detail


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch.core import sampler as SM
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
    from repro_torch.kernels.stream_norm.ops import (
        group_norm_plan,
        stream_group_norm,
        stream_group_norm_plain,
    )
    from repro_torch.kernels.uniconv.ops import (
        prepare_weights,
        tile_plan,
        uniconv,
        uniconv_apply,
    )
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
    # the tensor cores at work: HGMMA is a wgmma product, HMMA an mma.sync one
    sass = {name: build.sass_counts(name) for name in SASS_REQUIRED}
    print(f"[chip_smoke] SASS instruction counts (cuobjdump -sass): {sass}")
    detail["sass_counts"] = sass
    missing = [f"{name}: no {op}" for name, ops in SASS_REQUIRED.items() if sass[name] is not None
               for op in ops if sass[name][op] <= 0]
    if missing:
        raise AssertionError(f"a tensor-core product was not compiled: {missing}")
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
            err, tol, ms, pms, lms, bytes_ms, ops_ms, simt_ms = _check_shape(
                torch, F, ops, key, gen)
            row = dict(key=list(key), calls=n, max_abs_err=err, tol=tol, ms=ms, plain_ms=pms,
                       library_ms=lms, bytes_ms=bytes_ms, ops_ms=ops_ms, simt_ms=simt_ms)
            rows.append(row)
            by_key[key] = row
            bound, simt = max(bytes_ms, ops_ms), max(bytes_ms, simt_ms)
            share = (f" share {simt / ms:.0%} of the f32 SIMT bound {simt:.4f} ms, "
                     f"{bound / ms:.0%} of the 3xTF32 bound" if key[0] in TENSOR_CORE_3XTF32
                     else f" share {bound / ms:.0%}")
            print(f"[chip_smoke]   {key} x{n}: err {err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms "
                  f"plain {pms:.4f} ms library {lms:.4f} ms bound {bound:.4f} ms{share}")
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
    with torch.no_grad():
        detail["group_norm_shapes"] = _group_norm_lines(
            torch, ops, group_norm_plan, by_key, log.calls, gen)
    # uniconv's weight preparation (tf32 split, K-major, padded): paid once per
    # weight tensor and cached, so it is not in the kernel times above
    prep = {}
    for key in log.calls:
        if key[0] == "uniconv":
            _, xs, ws, hw, k, stride = key
            w = torch.randn(ws, generator=gen, device="cuda")
            m = xs[0] * (-(-hw[0] // stride)) * (-(-hw[1] // stride))
            bn = tile_plan(m, ws[2], ws[1], k).bn
            prep[key] = _ms(torch, lambda: prepare_weights(w, bn))
    prep_calls = sum(n * prep[key] for key, n in log.calls.items() if key in prep)
    print(f"[chip_smoke] uniconv weight prep (once per weight tensor, not in the kernel time): "
          f"{sum(prep.values()):.3f} ms over the {len(prep)} distinct shapes, "
          f"{prep_calls:.3f} ms weighted by calls")
    detail["uniconv_weight_prep_ms"] = {str(k): v for k, v in prep.items()}

    def summed(counts: dict[tuple, int]) -> dict[str, dict]:
        """Per kernel, over ``counts`` calls: launches, max error, and each
        time and bound summed with the number of calls at each shape."""
        out = {name: dict(launches=0, err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                          bytes_ms=0.0, ops_ms=0.0, simt_ms=0.0) for name in SOURCES}
        for key, n in counts.items():
            tot, row = out[key[0]], by_key[key]
            tot["launches"] += n
            tot["err"] = max(tot["err"], row["max_abs_err"])
            for f in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "simt_ms"):
                tot[f] += n * row[f]
        return out

    for phase, counts in log.by_phase.items():
        per = summed(counts)
        print(f"[chip_smoke] {phase}: U-Net/decoder pass cuda {pass_ms[phase]['cuda']:.2f} ms, "
              f"eager {pass_ms[phase]['eager']:.2f} ms")
        for name, v in per.items():
            simt = (f" (f32 SIMT bound {max(v['bytes_ms'], v['simt_ms']):.2f} ms)"
                    if name in TENSOR_CORE_3XTF32 else "")
            print(f"[chip_smoke]   {name}: {v['launches']} launches, kernel {v['ms']:.2f} ms, "
                  f"plain {v['plain_ms']:.2f} ms, library {v['library_ms']:.2f} ms, bound "
                  f"{max(v['bytes_ms'], v['ops_ms']):.2f} ms{simt}")
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
        if backend == "cuda":
            reduce_launches = uniconv.reduce_launches
            print(f"[chip_smoke]   uniconv split-K reduce launches (apart from its "
                  f"{launches['uniconv']}): {reduce_launches}")
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
                           uniconv_reduce_launches=reduce_launches,
                           latent_err=serve_err, latent_scale=scale, image_err=image_err)
    if not serve_err <= SERVE_TOL * scale:
        raise AssertionError(f"cuda latents differ from eager by {serve_err}")

    t0 = _phase("serve compared", t0)

    # 6. serve cached and conditioned -------------------------------------------------
    detail["serve_cached"] = _serve_cached_phase(torch, np, K, CFG, config, models, t0)

    # 7. calibrate ------------------------------------------------------------------------
    detail["calibrate"] = _calibrate_phase(
        torch, np, K, CFG, config, models, pass_ms[f"FULL micro-step {batch}"]["cuda"],
        time.perf_counter())

    # 8. serve over HTTP ---------------------------------------------------------------------
    detail["serve_http"] = _serve_http_phase(torch, K, time.perf_counter())

    # 9. serve through the router ---------------------------------------------------------------
    detail["router"] = _router_phase_run(torch, detail["serve_http"]["requests"],
                                         time.perf_counter())

    # 10. the sharded engine -------------------------------------------------------------------
    detail["sharded"] = _sharded_phase(
        torch, np, K, CFG, config, models, (requests, done_c), log,
        lambda key: _check_shape(torch, F, ops, key, gen), detail["serve_cached"]["micro_ms"],
        time.perf_counter())

    # 11. train ----------------------------------------------------------------------------------
    detail["train"] = _train_phase(torch, np, K, time.perf_counter())

    # 12. the LM transformer family ---------------------------------------------------------------
    detail["lm"] = _lm_phase(torch, np, K, time.perf_counter())

    # 13. the recurrent LM families and layer skipping -------------------------------------------
    # sd_v14's models and the last engine are done with: their card memory
    # goes back before hymba's full-width train step
    del engine, models, params, vae_params
    torch.cuda.empty_cache()
    detail["lm_recurrent"] = _recurrent_phase(torch, np, K, time.perf_counter())

    # 14. mesh costing: the dry run, and its model held against the card -------------------------
    detail["dryrun"] = _dryrun_phase(torch, K, card, time.perf_counter())

    # 15. distributed train: the mesh step over torch.distributed ranks --------------------------
    detail["distributed"] = _distributed_phase(torch, K, card, time.perf_counter())

    kernels = [
        _kernel_entry(name, src, rep, launches[name], totals[name])
        for name, (src, rep) in SOURCES.items()
    ] + [
        _kernel_entry(name, src, rep, reg_totals[name]["launches"], reg_totals[name])
        for name, (src, rep) in REGISTRY_SOURCES.items()
    ]
    # the float32 CUDA-core bound of the two 3xTF32 kernels: in the per-pass
    # lines and here, not in the kernels line, whose bound_ms is the 3xTF32 one
    all_totals = {**totals, **reg_totals}
    detail["fp32_simt_bound_ms"] = {
        name: max(all_totals[name]["bytes_ms"], all_totals[name]["simt_ms"])
        for name in TENSOR_CORE_3XTF32
    }
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
