"""Weights and state carried across from the JAX package's trees.

The JAX package keeps its parameters as nested dicts and lists of arrays,
and its optimizer state as named tuples of such trees; mapped through
``np.asarray`` they become the input here.  The layouts stay as they are
(conv ``[K*K, Cin, Cout]``, dense ``[in, out]``), so each JAX op maps to
one torch op.  Every floating leaf becomes a float32 tensor: a bfloat16
leaf is upcast exactly, which is what the JAX path computes with when it
promotes ``fp32 @ bf16`` to float32.  Integer leaves (AdamW's step) keep
their dtype.  A named tuple keeps its type, so its fields stay readable by
name.

The LM transformer is the exception (:func:`lm_params_from_numpy`): a
bfloat16 LM computes in bf16, while its norm scales, per-head q / k norms
and MoE router stay float32, so every LM leaf keeps its own dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.tree import tree_map


def _leaf_to_torch(leaf: Any, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    arr = arr.astype(arr.dtype if arr.dtype.kind == "i" else np.float32)  # a copy
    return torch.from_numpy(arr).to(device)


def tree_to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts/lists/tuples/named tuples of numpy arrays -> the same
    tree of tensors (float32, or the leaf's integer dtype)."""
    return tree_map(lambda leaf: _leaf_to_torch(leaf, device), tree)


def tree_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same tree of numpy arrays (float32
    for every floating tensor), for the JAX package to take back."""
    return tree_map(lambda t: t.detach().float().cpu().numpy() if t.is_floating_point()
                    else t.detach().cpu().numpy(), tree)


def _leaf_keep_dtype(leaf: Any, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # numpy's ml_dtypes bf16: via float32, exactly
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(arr.copy()).to(device)


def lm_params_from_numpy(tree: Any, device="cpu") -> Any:
    """JAX LM parameter tree (numpy leaves) -> the port's tree, each leaf in
    its own dtype (bfloat16 stays bfloat16, float32 stays float32), in the
    same layout: ``blocks.slotJ`` leaves keep their leading unit axis and
    ``tail`` stays a list, so checkpoint keys are the JAX package's."""
    return tree_map(lambda leaf: _leaf_keep_dtype(leaf, device), tree)


def unet_params_from_numpy(tree: Any, device="cpu") -> Any:
    """JAX U-Net parameter tree (numpy leaves) -> the port's tree."""
    return tree_to_torch(tree, device)


def vae_params_from_numpy(tree: Any, device="cpu") -> Any:
    """JAX VAE parameter tree (numpy leaves) -> the port's tree."""
    return tree_to_torch(tree, device)
