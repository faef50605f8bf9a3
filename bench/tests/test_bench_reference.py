"""The frozen reference against the port, on the CPU.

The reference (``bench/reference``) imports nothing of the port; these
tests import both: the weights the benchmark makes have the port's tree,
the reference's per-class operation counts are those of the served shapes,
and one request of each tier served by the port's engine at ``sd_toy``
matches the reference's straight-line run."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench import flops
from bench.reference import sd
from bench.reference.weights import _Spec, count, make_weights
from bench.tests.conftest import ROOT, TOY_UNET

#: operations of one CFG pair (batch 2) by class, and of one decode: the
#: reference counted on meta tensors.  SKETCH and REFINE equal the port's
#: eager U-Net's count; its FULL count is higher by three quarters of the
#: three stride-2 convs' products, which it computes at full resolution
#: and then subsamples.
EXPECTED = {
    "sd_v14": dict(FULL=1_606_546_882_560, SKETCH=610_845_327_360, REFINE=360_286_126_080,
                   DECODE=4_041_211_904),
}
PORT_FULL = {"sd_v14": 1_640_520_744_960}


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["sd_v14"])
def test_class_flops(name):
    cfg = _cfg(name)
    assert flops.class_flops(cfg["unet"], 3, 2, sd) == EXPECTED[name]


@pytest.mark.parametrize("name", ["sd_v14"])
def test_port_full_count_differs_only_by_strided_convs(name):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_unet_config
    from repro_torch.core import sampler as SM
    from repro_torch.models import unet as U

    ucfg = get_unet_config(name)
    params = U.init_unet(ucfg, U._Shapes())
    x = torch.empty(1, 4096, 4, device="meta")
    ctx2 = torch.empty(2, ucfg.ctx_len, ucfg.ctx_dim, device="meta")
    with FlopCounterMode(display=False) as fc:
        SM.cfg_unet_step(ucfg, params, 7.5, x, torch.tensor([981], device="meta"), ctx2)
    assert fc.get_total_flops() == PORT_FULL[name]
    # three 3x3 stride-2 convs (C = 320, 640, 1280 at 64, 32, 16 pixels a side),
    # batch 2: the port computes all four output phases, one is kept
    strided = sum(2 * 2 * (s // 2) ** 2 * c * c * 9 for s, c in ((64, 320), (32, 640), (16, 1280)))
    assert PORT_FULL[name] - EXPECTED[name]["FULL"] == 3 * strided


@pytest.mark.parametrize("name", ["sd_v14"])
def test_weights_have_the_port_tree(name):
    from repro_torch.configs import get_unet_config
    from repro_torch.models import unet as U
    from repro_torch.models import vae as V

    cfg = _cfg(name)
    s = _Spec()
    mine = sd.unet_layout(s, cfg["unet"])
    for holder, key, shape, _, _ in s.leaves:
        holder[key] = torch.empty(shape, device="meta")
    port = U.init_unet(get_unet_config(name), U._Shapes())

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(mine) == shapes(port)
    assert count(mine) == cfg["unet_parameters"]
    _, vae = make_weights(TOY_UNET, 0, "cpu", sd)
    port_vae = V.init_vae(torch.Generator().manual_seed(0))
    assert shapes(vae) == shapes(port_vae)


def test_weights_repeat_per_seed_and_are_bf16_values():
    cfg = dict(TOY_UNET, dtype="bfloat16")
    a, _ = make_weights(cfg, 2**31 + 3, "cpu", sd)
    b, _ = make_weights(cfg, 2**31 + 3, "cpu", sd)
    c, _ = make_weights(cfg, 4, "cpu", sd)
    w = a["down"][0]["res"]["conv1"]["w"]
    assert torch.equal(w, b["down"][0]["res"]["conv1"]["w"])
    assert not torch.equal(w, c["down"][0]["res"]["conv1"]["w"])
    assert torch.equal(w, w.to(torch.bfloat16).float())
    assert w.std().item() == pytest.approx((9 * 32) ** -0.5, rel=0.1)


def test_biases_and_norm_affines_are_drawn():
    """No bias is zero and no norm is the identity, so a kernel that drops
    or misplaces one changes the output."""
    unet, vae = make_weights(TOY_UNET, 9, "cpu", sd)
    res = unet["down"][0]["res"]
    for leaf in (res["conv1"]["b"], res["t_proj"]["b"], unet["time_mlp"]["b1"],
                 res["gn1"]["bias"], unet["down"][0]["tf"][0]["ln1"]["bias"], vae["dec_gn"]["bias"]):
        assert leaf.std().item() == pytest.approx(0.05, rel=0.35)
    for leaf in (res["gn1"]["scale"], unet["down"][0]["tf"][0]["ln2"]["scale"], vae["dec_gn"]["scale"]):
        assert leaf.mean().item() == pytest.approx(1.0, abs=0.06)
        assert leaf.std().item() == pytest.approx(0.1, rel=0.4)


@pytest.fixture(scope="module")
def served_toy():
    """One request of each tier served by the port's engine on the CPU
    (2 lanes, 8 steps), on the benchmark's weights."""
    from repro_torch.common.types import DiffusionConfig
    from repro_torch.configs import get_unet_config
    from repro_torch.serving.config import build_engine
    from repro_torch.serving.engine import EngineConfig, GenRequest

    unet_w, vae_w = make_weights(TOY_UNET, 11, "cpu", sd)
    ucfg = get_unet_config("sd_toy")
    dcfg = DiffusionConfig(timesteps_sample=8, scheduler="pndm", guidance_scale=7.5)
    config = EngineConfig(n_lanes=2, max_steps=8, l_sketch=3, l_refine=2, device="cpu",
                          backend="eager", unet="sd_toy")
    bundle = build_engine(config, models=(ucfg, dcfg, unet_w, vae_w))
    rng = np.random.default_rng(5)
    reqs = {}
    for rid, tier in enumerate(("draft", "balanced", "high", "exact")):
        pol = bundle.policy.resolve(8, quality=tier)
        ctx = (rng.normal(size=(8, 32)) * 0.2).astype(np.float32)
        noise = rng.normal(size=(256, 4)).astype(np.float32)
        reqs[rid] = (tier, ctx, noise, GenRequest(rid=rid, ctx=ctx, noise=noise, timesteps=8,
                                                  plan=pol.plan, policy=pol))
    done, _ = bundle.engine.run([r[3] for r in reqs.values()])
    return reqs, {c.rid: c for c in done}


@pytest.mark.parametrize("tier", ["draft", "balanced", "high", "exact"])
def test_reference_matches_the_served_engine_at_sd_toy(served_toy, tier):
    reqs, done = served_toy
    rid = next(i for i, r in reqs.items() if r[0] == tier)
    _, ctx, noise, _ = reqs[rid]
    unet_w, vae_w = make_weights(TOY_UNET, 11, "cpu", sd)
    sampler = json.loads((ROOT / "bench" / "configs" / "sd_v14.json").read_text())["sampler"]
    sampler = dict(sampler, steps=8)
    with torch.no_grad(), sd.precision("fp32", torch.device("cpu")):
        lat = sd.sample(TOY_UNET, sampler, unet_w, torch.from_numpy(noise)[None],
                        {"ctx": torch.from_numpy(ctx)[None]}, tier, l_sketch=3, l_refine=2)
        img = sd.vae_decode(vae_w, lat, (16, 16))
    served = done[rid]
    scale = float(lat.abs().max())
    assert float(np.abs(served.latent - lat[0].numpy()).max()) <= 1e-4 * scale
    assert float(np.abs(served.image - img[0].numpy()).max()) <= 1e-4 * float(img.abs().max())


def test_tier_plans_match_the_served_policy():
    from repro_torch.core import sampler as SM
    from repro_torch.serving.policy import QualityPolicy

    pol = QualityPolicy(12, l_sketch=3, l_refine=2)
    for steps in (8, 25, 50):
        for tier in ("draft", "balanced", "high", "exact"):
            plan = pol.resolve(steps, quality=tier).plan
            port = [SM.FULL] * steps if plan is None else SM.plan_to_branches(plan, steps)
            assert sd.pas_branches(sd.tier_plan(tier, steps), steps) == port
