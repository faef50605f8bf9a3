"""Softmax attention: plain versions and the flash-attention kernel.

* :func:`mha` is the plain multi-head attention of
  ``repro/models/unet.py::_mha`` on already-projected [B, L, C] tensors,
  including the output projection.
* :func:`flash_attention_ref` is the plain version of
  ``repro/kernels/flash_attention/ref.py`` on [B, H, S, Dh] heads with the
  causal, window, softcap and grouped-query options.
* :func:`flash_attention` is the wrapper of the hand-written Hopper kernel
  (``kernels/csrc/flash_attention.cu``), which replaces
  ``repro/kernels/flash_attention/kernel.py::flash_attention`` with the same
  signature.  Bound by operations at the served shapes, which it runs on the
  tensor cores (``mma.sync`` TF32 in split-precision "3xTF32", float32-level
  error); the online max/exp-sum keeps the logits out of device memory.  It
  takes :func:`flash_attention_ref` only for a tensor on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

#: widest head the kernel is instantiated for
MAX_HEAD_DIM = 160


def mha(q, k, v, o_proj, n_heads: int) -> torch.Tensor:
    bsz, lq, c = q.shape
    lk = k.shape[1]
    dh = c // n_heads
    qh = q.reshape(bsz, lq, n_heads, dh).transpose(1, 2) * dh**-0.5
    kh = k.reshape(bsz, lk, n_heads, dh).transpose(1, 2)
    vh = v.reshape(bsz, lk, n_heads, dh).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)).float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = (w @ vh).transpose(1, 2).reshape(bsz, lq, c)
    return out @ o_proj


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    h, sq, dh = q.shape[1], q.shape[2], q.shape[3]
    hkv, skv = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, h // hkv, dim=1)
    v = torch.repeat_interleave(v, h // hkv, dim=1)
    logits = (q @ k.transpose(-1, -2)).float() / dh**0.5
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    logits = torch.where(mask, logits, torch.full((), -1e30, device=q.device))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return w @ v


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """``softmax(q k^T / sqrt(Dh)) v`` through the Hopper kernel.

    ``q`` is [B, H, Sq, Dh]; ``k``/``v`` are [B, Hkv, Skv, Dh] with
    ``H % Hkv == 0``.  ``causal``/``window`` assume aligned positions.
    """
    build.forbid_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    bsz, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (
        k.shape != (bsz, hkv, skv, dh) or v.shape != k.shape or h % hkv
        or not 0 < dh <= MAX_HEAD_DIM
    ):
        raise ValueError(
            f"flash_attention: q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}"
        )
    build.require_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    build.launch(
        "flash_attention_f32", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bsz, h, hkv, sq, skv, dh, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(dh),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
