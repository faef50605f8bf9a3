"""The model module ``sdxl`` (``bench/reference/sdxl.py``) at the published
widths of ``configs/sdxl_base.json``, on meta tensors: its tree is the
port's, its parameters are the published count less the biases the port
does not hold, its operations those of SDXL, and its conditioning and
classifier-free guidance follow the base pipeline."""
from __future__ import annotations

import json

import numpy as np
import torch

from bench import flops, spec
from bench.reference.weights import _Spec, count
from bench.tests.conftest import ROOT

XL = spec.load_model("sdxl")
CFG = json.loads((ROOT / "bench" / "configs" / "sdxl_base.json").read_text())
U = CFG["unet"]
#: stabilityai/stable-diffusion-xl-base-1.0's U-Net, and the biases the port
#: leaves out: the attention out-projections' (2 C) and the GEGLU
#: feed-forward's (8 C in, C out), 11 C in each of the 70 basic blocks
#: (2 x 2 + 3 x 2 at 640 channels, 2 x 10 + 3 x 10 + 10 at 1280)
PUBLISHED = 2_567_463_684
MISSING_BIASES = 11 * (10 * 640 + 60 * 1280)


def _meta_tree(layout):
    s = _Spec()
    tree = layout(s, U)
    for holder, key, shape, _, _ in s.leaves:
        holder[key] = torch.empty(shape, device="meta")
    return tree


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shapes(v) for v in t]
    return tuple(t.shape)


def test_layout_is_the_port_tree_and_the_published_count():
    from repro_torch.configs import get_unet_config
    from repro_torch.models import unet as PU

    tree = _meta_tree(XL.unet_layout)
    assert MISSING_BIASES == 915_200
    assert count(tree) == CFG["unet_parameters"] == PUBLISHED - MISSING_BIASES
    assert _shapes(tree) == _shapes(PU.init_unet(get_unet_config("sdxl_base"), PU._Shapes()))
    assert [len(blk.get("tf", [])) for blk in tree["down"]] == [0, 0, 0, 2, 2, 0, 10, 10]
    assert len(tree["mid"]["tf"]) == 10
    assert tree["add_embedding"]["w1"].shape == (1280 + 6 * 256, 1280)


def test_class_flops_are_sdxls():
    """A FULL CFG pair is 13.5 TFLOP (8.4 x sd_v14's); the partial passes
    enter at level 0's up-steps, which hold no attention."""
    out = flops.class_flops(U, CFG["engine"]["l_sketch"], CFG["engine"]["l_refine"], XL)
    assert 13.3e12 <= out["FULL"] <= 13.7e12
    assert out["REFINE"] < out["SKETCH"] < out["FULL"] / 10


def test_conditioning_and_its_unconditional_half():
    assert XL.conditioning_shapes(U) == {"ctx": (77, 2048), "pooled": (1280,), "time_ids": (6,)}
    rng, plain = np.random.default_rng(7), np.random.default_rng(7)
    cond = XL.conditioning(U, rng)
    assert np.array_equal(cond["ctx"], (plain.normal(size=(77, 2048)) * 0.2).astype(np.float32))
    assert cond["pooled"].shape == (1280,) and cond["pooled"].dtype == np.float32
    assert cond["time_ids"].tolist() == [1024, 1024, 0, 0, 1024, 1024]
    batch = {k: torch.from_numpy(v)[None] for k, v in cond.items()}
    both = XL.with_unconditional(batch)
    assert torch.equal(both["ctx"][1], torch.zeros(77, 2048))
    assert torch.equal(both["pooled"][1], torch.zeros(1280))
    assert torch.equal(both["time_ids"][1], batch["time_ids"][0])
