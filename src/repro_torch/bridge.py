"""Weights carried across from the JAX package's parameter trees.

The JAX package keeps its parameters as nested dicts and lists of arrays;
mapped through ``np.asarray`` they become the input here.  The layouts stay
as they are (conv ``[K*K, Cin, Cout]``, dense ``[in, out]``), so each JAX op
maps to one torch op.  Every leaf becomes a float32 tensor: a bfloat16 leaf
is upcast exactly, which is what the JAX path computes with when it
promotes ``fp32 @ bf16`` to float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tree_to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts/lists/tuples of numpy arrays -> the same tree of float32 tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    return torch.from_numpy(np.asarray(tree).astype(np.float32)).to(device)


def unet_params_from_numpy(tree: Any, device="cpu") -> Any:
    """JAX U-Net parameter tree (numpy leaves) -> the port's tree."""
    return tree_to_torch(tree, device)


def vae_params_from_numpy(tree: Any, device="cpu") -> Any:
    """JAX VAE parameter tree (numpy leaves) -> the port's tree."""
    return tree_to_torch(tree, device)
