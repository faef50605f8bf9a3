"""Deterministic, host-sharded synthetic data pipelines.

The port's own copy of ``repro/data/pipeline.py`` (numpy only, so the
batches are bitwise the JAX package's for the same seed, step and host).

Production posture: each host process materializes only its slice of the
global batch (``process_index``/``process_count`` aware), batches are
addressable by step so a restart at step N regenerates the exact stream
(checkpoint/restart determinism), and an async prefetch thread keeps one
batch ahead of the device (compute/IO overlap).

Two generators:
* token streams for the LM archs (structured enough to be learnable; no
  trainer of the port reads them before the LM substrate is ported);
* latent "images" for the diffusion trainer (mixtures of geometric
  patterns so PAS quality differences are visible).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.process_count == 0
        return self.global_batch // self.process_count


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    # independent stream per (seed, step, host) -> restart-deterministic
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.process_index])
    )


def token_batch(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Markov-ish synthetic tokens: learnable bigram structure + noise."""
    rng = _rng_for(cfg, step)
    b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    base = rng.integers(0, v, size=(b, 1))
    steps = rng.integers(1, 7, size=(b, s))
    toks = (base + np.cumsum(steps, axis=1)) % v
    noise = rng.random((b, s)) < 0.05
    toks = np.where(noise, rng.integers(0, v, size=(b, s)), toks)
    tokens = toks.astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def latent_batch(cfg: DataConfig, step: int, *, size: int, channels: int = 4) -> dict[str, np.ndarray]:
    """Structured latents: oriented stripes + blobs, class-conditioned."""
    rng = _rng_for(cfg, step)
    b = cfg.host_batch
    yy, xx = np.mgrid[0:size, 0:size] / size
    lat = np.zeros((b, size, size, channels), np.float32)
    cls = rng.integers(0, cfg.vocab_size, size=(b,))
    for i in range(b):
        c = cls[i]
        freq = 2 + (c % 4) * 2
        phase = rng.random() * 2 * np.pi
        angle = (c // 4) * np.pi / 4
        wave = np.sin(freq * 2 * np.pi * (np.cos(angle) * xx + np.sin(angle) * yy) + phase)
        cy, cx = rng.random(2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02)
        for ch in range(channels):
            lat[i, :, :, ch] = wave * (0.5 + 0.5 * ((c + ch) % 2)) + blob * ((ch % 2) * 2 - 1)
    lat += rng.normal(0, 0.05, lat.shape).astype(np.float32)
    return {
        "latents": lat.reshape(b, size * size, channels),
        "class_id": cls.astype(np.int32),
    }


class Prefetcher:
    """One-batch-ahead async prefetch (host-side compute/IO overlap)."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
