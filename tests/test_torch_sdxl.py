"""SDXL base 1.0's U-Net in the port (``sdxl_base``) against the benchmark's
plain reference (``bench/reference/sdxl.py``), on the CPU at a toy size.

The toy keeps what SDXL adds: 3 levels, no attention at level 0, stacks
of depth 1 and 2 (and 2 in the mid block), 8-wide heads (2 and 4 of them),
the pooled vector and 6 time ids through 8-wide sinusoids.  On the
reference's seeded weights (every bias and norm affine drawn):

* the port's eager U-Net matches the reference at FULL and at both
  partial entries;
* the served engine (2 lanes, an ``exact`` and a ``balanced`` request, so
  the vote advances one lane of two on most steps) matches the reference's
  straight-line ``sample``;
* a stack of depth 2 is not two depth-1 sites;
* two planted faults fail: the time ids left out of the embedding, the
  pooled row left in CFG's unconditional half;
* admission refuses conditioning that does not fit the U-Net, the feature
  cache never serves a request from another request's time ids, and the
  HTTP factory gives an SDXL request its pooled vector and time ids.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common.types import (
    DiffusionConfig, UNetConfig, added_cond_dim, heads_at, site_depths)
from repro_torch.configs import get_unet_config
from repro_torch.serving import lanes as LN
from repro_torch.serving.config import build_engine
from repro_torch.serving.engine import EngineConfig, GenRequest, default_time_ids
from repro_torch.serving.frontend import RequestFactory

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import spec  # noqa: E402
from bench.reference.weights import make_weights  # noqa: E402

from repro_torch.models import unet as U  # noqa: E402

XL = spec.load_model("sdxl")
TOY = UNetConfig(
    name="sdxl_toy", base_channels=32, channel_mult=(1, 2, 4), n_res_blocks=1,
    attn_levels=(1, 2), tf_depths=(1, 1, 2), head_dim=8, ctx_dim=32, ctx_len=8, time_dim=128,
    groups=8, latent_size=16, pooled_dim=16, n_time_ids=6, time_id_dim=8,
)
CFG = {f: list(v) if isinstance(v, tuple) else v for f, v in vars(TOY).items() if f != "name"}
STEPS = 8
L_SKETCH, L_REFINE = 3, 2
SAMPLER = dict(steps=STEPS, scheduler="pndm", timesteps_train=1000, beta_start=0.00085,
               beta_end=0.012, beta_schedule="scaled_linear", guidance_scale=7.5)
DCFG = DiffusionConfig(timesteps_sample=STEPS, scheduler="pndm", guidance_scale=7.5)
SEED = 2**31 + 29
#: float32 on one CPU: the port and the reference order their sums
#: differently (measured: eps within 1.5e-6 of its max |value| at FULL and
#: 5e-7 at the partial entries, served latents within 2.9e-6); each planted
#: fault is held to move the output by more than 1e-2
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return make_weights(CFG, SEED, "cpu", XL)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _inputs(batch: int = 2):
    rng = np.random.default_rng(3)
    conds = [XL.conditioning(CFG, rng) for _ in range(batch)]
    cond = {k: torch.from_numpy(np.stack([c[k] for c in conds])) for k in conds[0]}
    x = torch.from_numpy(rng.normal(size=(batch, 256, 4)).astype(np.float32))
    return x, torch.tensor([981, 421]), cond


def _port(params, x, t, cond, **kw):
    return U.unet_apply(TOY, params, x, t, cond["ctx"], pooled=cond["pooled"],
                        time_ids=cond["time_ids"], **kw)


def test_config_is_the_published_unet():
    cfg = get_unet_config("sdxl_base")
    assert (cfg.tf_depths, cfg.head_dim, added_cond_dim(cfg)) == ((1, 2, 10), 64, 2816)
    assert [heads_at(cfg, c) for c in (640, 1280)] == [10, 20]
    assert [site_depths(cfg, lvl) for lvl in (1, 2, None)] == [(2,), (10,), (10,)]


@pytest.mark.parametrize("entry", ["full", "sketch", "refine"])
def test_unet_matches_the_reference(weights, entry):
    x, t, cond = _inputs()
    n_up = U.n_up_steps(TOY)
    e = {"full": 0, "sketch": n_up - L_SKETCH, "refine": n_up - L_REFINE}[entry]
    with torch.no_grad(), XL.precision("fp32", torch.device("cpu")):
        ref, feats = XL.unet(CFG, weights[0], x, t, cond, capture=(e,) if e else ())
        if e:
            ref, _ = XL.unet(CFG, weights[0], x, t, cond, entry=e, feat=feats[e])
        ours, _ = _port(weights[0], x, t, cond, entry_step=e, entry_feat=feats.get(e))
    assert _rel(ours, ref) < TOL


def test_stack_is_not_two_sites(weights):
    """The mid block's stack through the port equals the reference's stack, and
    differs from the same blocks run as two whole sites (each with a group
    norm, projections and residual of its own)."""
    blocks = weights[0]["mid"]["tf"]
    assert len(blocks) == 2 and "proj_out" not in blocks[0] and "gn" not in blocks[1]
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(2, 16, 128)).astype(np.float32))
    ctx = torch.from_numpy((rng.normal(size=(2, 8, 32)) * 0.2).astype(np.float32))
    with torch.no_grad():
        stack = U.apply_tf_stack(blocks, h, ctx, (4, 4), 16, 8)
        ref = XL.transformer_stack(blocks, h, ctx, (4, 4), 16, 8)
        first = dict(blocks[0], proj_out=blocks[1]["proj_out"])
        second = dict(blocks[1], gn=blocks[0]["gn"], proj_in=blocks[0]["proj_in"])
        sites = U.apply_tf_stack([second], U.apply_tf_stack([first], h, ctx, (4, 4), 16, 8),
                                 ctx, (4, 4), 16, 8)
    assert _rel(stack, ref) < TOL
    assert _rel(sites, ref) > 1e-2


def test_time_ids_left_out_fail(weights, monkeypatch):
    x, t, cond = _inputs()
    sinusoid = U.timestep_embedding
    with torch.no_grad(), XL.precision("fp32", torch.device("cpu")):
        ref, _ = XL.unet(CFG, weights[0], x, t, cond)
        monkeypatch.setattr(U, "timestep_embedding", lambda ts, dim: torch.zeros(
            (ts.shape[0], dim)) if dim == TOY.time_id_dim else sinusoid(ts, dim))
        ours, _ = _port(weights[0], x, t, cond)
    assert _rel(ours, ref) > 1e-2


def _engine(weights, n_lanes=2, **kw):
    config = EngineConfig(n_lanes=n_lanes, max_steps=STEPS, l_sketch=L_SKETCH, l_refine=L_REFINE,
                          device="cpu", backend="eager", unet="sdxl_base", **kw)
    return build_engine(config, models=(TOY, DCFG, *weights))


def _request(bundle, rid, tier, cond, noise, **kw):
    pol = bundle.policy.resolve(STEPS, quality=tier)
    return GenRequest(rid=rid, **cond, noise=noise, timesteps=STEPS, plan=pol.plan, policy=pol,
                      **kw)


def _served(weights, tiers=("exact", "balanced")):
    bundle = _engine(weights)
    rng = np.random.default_rng(11)
    reqs = []
    for rid, tier in enumerate(tiers):
        cond = XL.conditioning(CFG, rng)
        noise = rng.normal(size=(256, 4)).astype(np.float32)
        reqs.append((tier, cond, noise, _request(bundle, rid, tier, cond, noise)))
    done, _ = bundle.engine.run([r[3] for r in reqs])
    m = bundle.engine.metrics
    return reqs, {c.rid: c for c in done}, (m.lane_steps_advanced, m.micro_steps * 2)


def _reference(weights, tier, cond, noise):
    with torch.no_grad(), XL.precision("fp32", torch.device("cpu")):
        return XL.sample(CFG, SAMPLER, weights[0], torch.from_numpy(noise)[None],
                         {k: torch.from_numpy(v)[None] for k, v in cond.items()}, tier,
                         l_sketch=L_SKETCH, l_refine=L_REFINE)[0]


def test_served_latents_match_the_reference(weights):
    reqs, done, (advanced, held) = _served(weights)
    assert advanced < held  # the vote ran the U-Net on one lane of two
    for rid, (tier, cond, noise, _) in enumerate(reqs):
        ref = _reference(weights, tier, cond, noise)
        assert _rel(torch.from_numpy(done[rid].latent), ref) < TOL


def test_pooled_left_in_the_unconditional_row_fails(weights, monkeypatch):
    admit = LN.admit

    def leaky(state, lane, *args, **kw):
        admit(state, lane, *args, **kw)
        state.pooled2[state.n_lanes + lane] = state.pooled2[lane]

    monkeypatch.setattr(LN, "admit", leaky)
    reqs, done, _ = _served(weights, tiers=("exact",))
    tier, cond, noise, _ = reqs[0]
    assert _rel(torch.from_numpy(done[0].latent), _reference(weights, tier, cond, noise)) > 1e-2


def test_admission_refuses_conditioning_that_does_not_fit(weights):
    bundle = _engine(weights)
    rng = np.random.default_rng(5)
    cond = XL.conditioning(CFG, rng)
    noise = rng.normal(size=(256, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="pooled"):
        bundle.engine.submit(GenRequest(rid=0, ctx=cond["ctx"], noise=noise, timesteps=STEPS,
                                        time_ids=cond["time_ids"]))
    with pytest.raises(ValueError, match="time_ids"):
        bundle.engine.submit(GenRequest(rid=1, ctx=cond["ctx"], noise=noise, timesteps=STEPS,
                                        pooled=cond["pooled"], time_ids=cond["time_ids"][:4]))
    toy = build_engine(EngineConfig(n_lanes=1, max_steps=STEPS, device="cpu", backend="eager"))
    ctx = np.zeros((8, 32), np.float32)
    with pytest.raises(ValueError, match="pooled"):
        toy.engine.submit(GenRequest(rid=2, ctx=ctx, noise=noise, timesteps=STEPS,
                                     pooled=cond["pooled"]))
    assert toy.engine._state.pooled2 is None and toy.engine._state.time_ids2 is None


@pytest.mark.parametrize("same_ids", [True, False])
def test_cache_never_crosses_time_ids(weights, same_ids):
    """One lane, a cross cache and a loose threshold: the second of two
    requests with one ctx and pooled vector is served from the first's
    captures where their time ids agree, and never where they differ."""
    bundle = _engine(weights, n_lanes=1, cache_mode="cross", cache_threshold=0.5)
    rng = np.random.default_rng(6)
    cond = XL.conditioning(CFG, rng)
    noise = rng.normal(size=(256, 4)).astype(np.float32)
    other = dict(cond, time_ids=cond["time_ids"] if same_ids else cond["time_ids"] * 0.5)
    first = GenRequest(rid=0, **cond, noise=noise, timesteps=STEPS)
    second = GenRequest(rid=1, **other, noise=noise, timesteps=STEPS, arrival_s=1.0)
    bundle.engine.run([first, second])
    hits = bundle.engine.metrics.hbm_hits
    assert (hits > 0) if same_ids else (hits == 0)
    assert (first.cache_offset == second.cache_offset) == same_ids


def test_http_factory_gives_sdxl_conditioning(weights):
    config = EngineConfig(n_lanes=1, max_steps=STEPS, l_sketch=L_SKETCH, l_refine=L_REFINE,
                          device="cpu", backend="eager")
    (req,), _, _ = RequestFactory(TOY, DCFG, config).build(
        {"prompt": "a lighthouse", "seed": 3, "timesteps": STEPS})
    assert req.pooled.shape == (16,) and req.pooled.dtype == np.float32
    assert req.time_ids.tolist() == [128, 128, 0, 0, 128, 128]
    assert default_time_ids(get_unet_config("sdxl_base")).tolist() == [1024, 1024, 0, 0, 1024, 1024]
    (plain,), _, _ = RequestFactory(get_unet_config("sd_toy"), DCFG, config).build(
        {"prompt": "a lighthouse", "seed": 3, "timesteps": STEPS})
    assert plain.pooled is None and plain.time_ids is None
    bundle = _engine(weights, n_lanes=1)
    done, _ = bundle.engine.run([req])
    assert np.isfinite(done[0].latent).all()
