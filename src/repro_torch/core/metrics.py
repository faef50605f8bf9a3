"""Quality proxies for PAS validation under offline constraints.

The port's own copy of ``repro/core/metrics.py``.  Neither pretrained
weights nor scoring networks (CLIP, FID, IS) are available offline, so the
framework's validation stage compares the PAS output with the full
sampler's output for the same seed and prompt.  mse and psnr are float32
torch on the device that holds the latents; the cosine is float64 numpy
on the host, as the reference computes each.
"""
from __future__ import annotations

import numpy as np
import torch


def latent_mse(a, b) -> float:
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    return float(torch.mean((a - b) ** 2))


def latent_psnr(a, b) -> float:
    b = torch.as_tensor(b, dtype=torch.float32)
    rng = float(torch.clamp(b.max() - b.min(), min=1e-6))
    mse = latent_mse(a, b)
    return float(20 * np.log10(rng) - 10 * np.log10(max(mse, 1e-12)))


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu").numpy()
    return np.asarray(x, np.float64).ravel()


def latent_cosine(a, b) -> float:
    af, bf = _host64(a), _host64(b)
    return float(af @ bf / (np.linalg.norm(af) * np.linalg.norm(bf) + 1e-12))
