"""How far the JAX reference's own xlstm decode drifts from its forward.

Runs ``repro``'s xlstm-350m at its full width (d_model 1024, 4 heads,
24 layers; the vocabulary cut to ``--vocab`` so the CPU keeps up) from a
random init, in float32 and in bfloat16: teacher-forced decode over
``--seq`` random tokens against one forward over the same tokens, and
prints the largest difference relative to max |logit|, overall and per
position.  ``chip_smoke.py`` phase 13 gates the port's decode against
its forward in float32 and only prints bf16; this script shows that the
reference itself parts in bf16 by the same order.

Usage (CPU, about a minute):
  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_decode_drift.py
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_lm_config
from repro.launch.steps import get_adapter


def drift(dtype: str, layers: int, vocab: int, batch: int, seq: int) -> np.ndarray:
    """Per-position max |decode - forward| / max |forward logit|."""
    cfg = dataclasses.replace(get_lm_config("xlstm-350m", "full"), n_layers=layers,
                              vocab_size=vocab, dtype=dtype)
    ad = get_adapter(cfg)
    params = jax.jit(ad.init)(jax.random.key(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(0, vocab, size=(batch, seq)),
                       jnp.int32)
    full, _ = jax.jit(ad.forward)(params, toks)
    decode = jax.jit(ad.decode)
    state, steps = ad.init_cache(batch, seq), []
    for pos in range(seq):
        lg, state = decode(params, state, toks[:, pos], jnp.asarray(pos, jnp.int32))
        steps.append(np.asarray(lg, np.float32))
    full = np.asarray(full, np.float32)
    return np.abs(np.stack(steps, 1) - full).max(axis=(0, 2)) / np.abs(full).max()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    for dtype in ("float32", "bfloat16"):
        per = drift(dtype, args.layers, args.vocab, args.batch, args.seq)
        print(f"xlstm-350m full width, {args.layers} layers, vocab {args.vocab}, {dtype}: "
              f"decode vs forward over {args.seq} positions x {args.batch}: max {per.max():.4g} "
              f"of max |logit| (first 4 positions {' '.join(f'{x:.3g}' for x in per[:4])}; "
              f"last 4 {' '.join(f'{x:.3g}' for x in per[-4:])})", flush=True)


if __name__ == "__main__":
    main()
