"""The port's optimisation framework (paper Sec. III-C, Fig. 7) and reuse
planner (Sec. V) against the JAX package's, and its two examples.

The MAC model, the plan search and the reuse planner are integer and
float64 arithmetic on the config: equal, not close, for every U-Net config
both packages define.  Stage 4 runs with the real evaluator, the PAS
sampler against the all-FULL sampler on bridged sd_toy weights: qualities
within 1e-5 (measured 1.5e-8 on cosines 0.973 and 0.9998), the same valid
plans.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import DiffusionConfig as JDiffusionConfig
from repro.configs import UNET_CONFIGS as J_UNET_CONFIGS
from repro.core import framework as JFW
from repro.core import metrics as JM
from repro.core import reuse_planner as JRP
from repro.core import sampler as JSM
from repro.models import unet as JU
from repro_torch import bridge
from repro_torch.common.types import DiffusionConfig
from repro_torch.configs import UNET_CONFIGS
from repro_torch.core import framework as TFW
from repro_torch.core import metrics as TM
from repro_torch.core import reuse_planner as TRP
from repro_torch.core import sampler as TSM
from repro_torch.core import shift_score as TSS
from repro_torch.serving import config as TCFG
from repro_torch.serving import policy as TP
from repro_torch.serving.engine import EngineConfig
from test_torch_unet import _numpy_tree

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
#: configurations of the port alone: the JAX package has no SDXL at its
#: published widths
PORT_ONLY = ("sdxl_base",)
CONFIGS = sorted(set(UNET_CONFIGS) - set(PORT_ONLY))
MB = 2**20
CONSTRAINTS = {
    "reference": dict(total_steps=50, d_star=20, n_outlier_blocks=2, min_quality=0.0),
    "example": dict(total_steps=16, d_star=3, n_outlier_blocks=1, min_quality=0.9,
                    t_complete_range=(1, 2, 3), t_sparse_range=(2, 3, 4)),
    "narrow": dict(total_steps=25, d_star=12, n_outlier_blocks=4, min_quality=0.5,
                   l_sketch_range=(2, 3, 4, 5), l_refine_range=(2, 3, 4)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _solutions(sols):
    return [(dataclasses.astuple(s.plan), s.mac_reduction, s.quality, s.valid) for s in sols]


def test_both_packages_define_the_same_unet_configs():
    assert sorted(J_UNET_CONFIGS) == CONFIGS
    assert sorted(UNET_CONFIGS) == sorted(CONFIGS + list(PORT_ONLY))


@pytest.mark.parametrize("name", CONFIGS)
def test_mac_breakdown_and_cost_function_match_jax(name):
    jc, tc = J_UNET_CONFIGS[name], UNET_CONFIGS[name]
    br = TFW.unet_mac_breakdown(tc)
    assert dataclasses.astuple(br) == dataclasses.astuple(JFW.unet_mac_breakdown(jc))
    assert br.total == JFW.unet_mac_breakdown(jc).total
    jf, tf = JFW.cost_function(jc), TFW.cost_function(tc)
    for l in range(-1, len(br.up) + 2):
        assert tf(l) == jf(l)


@pytest.mark.parametrize("cons", list(CONSTRAINTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_search_plans_and_mac_reduction_match_jax(name, cons):
    jc, tc = J_UNET_CONFIGS[name], UNET_CONFIGS[name]
    want = JFW.search_plans(jc, JFW.SearchConstraints(**CONSTRAINTS[cons]))
    got = TFW.search_plans(tc, TFW.SearchConstraints(**CONSTRAINTS[cons]))
    assert got and _solutions(got) == _solutions(want)
    total = CONSTRAINTS[cons]["total_steps"]
    for jsol, tsol in zip(want[::7], got[::7]):
        assert TFW.mac_reduction(tc, tsol.plan, total) == JFW.mac_reduction(jc, jsol.plan, total)


@pytest.fixture(scope="module")
def validated():
    """Stage 4 on both packages: the example's search at 8 steps (D* 3, one
    outlier block), its most and its least aggressive plan run against the
    all-FULL sampler, at a bar (0.99) between their qualities (the JAX
    sampler compiles once per plan, some 12 s each at sd_toy)."""
    cfg = J_UNET_CONFIGS["sd_toy"]
    tree = _numpy_tree(lambda k: JU.init_unet(k, cfg), seed=2)
    rng = np.random.default_rng(3)
    noise = rng.normal(size=(2, cfg.latent_size**2, cfg.in_channels)).astype(np.float32)
    ctx = (rng.normal(size=(2, cfg.ctx_len, cfg.ctx_dim)) * 0.3).astype(np.float32)
    cons = dict(CONSTRAINTS["example"], total_steps=8)
    out = {}
    for pkg, FW, SM, metrics, dcfg, params, arr in (
        ("jax", JFW, JSM, JM, JDiffusionConfig(timesteps_sample=8),
         jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray),
        ("port", TFW, TSM, TM, DiffusionConfig(timesteps_sample=8),
         bridge.unet_params_from_numpy(tree), torch.from_numpy),
    ):
        ucfg = J_UNET_CONFIGS["sd_toy"] if pkg == "jax" else UNET_CONFIGS["sd_toy"]
        x, c = arr(noise), arr(ctx)
        un = c * 0
        full = SM.pas_denoise(ucfg, dcfg, params, None, x, c, un)

        def quality(plan):
            return metrics.latent_cosine(SM.pas_denoise(ucfg, dcfg, params, plan, x, c, un), full)

        sols = FW.search_plans(ucfg, FW.SearchConstraints(**cons))
        sols = [sols[0], sols[-1]]
        with torch.no_grad():
            valid = FW.validate_solutions(sols, quality, 0.99, max_evals=2)
        out[pkg] = (sols, valid)
    return out


def test_validate_solutions_qualities_match_jax(validated):
    (jsols, _), (tsols, _) = validated["jax"], validated["port"]
    evaluated = [s for s in tsols if s.quality is not None]
    assert len(evaluated) == 2
    assert [s.valid for s in evaluated] == [False, True]
    for jsol, tsol in zip(jsols, evaluated):
        assert dataclasses.astuple(tsol.plan) == dataclasses.astuple(jsol.plan)
        assert abs(tsol.quality - jsol.quality) <= 1e-5
        assert tsol.valid == jsol.valid


def test_validate_solutions_valid_list_matches_jax(validated):
    (_, jvalid), (_, tvalid) = validated["jax"], validated["port"]
    assert [dataclasses.astuple(s.plan) for s in tvalid] == [
        dataclasses.astuple(s.plan) for s in jvalid]
    reds = [s.mac_reduction for s in tvalid]
    assert reds == sorted(reds, reverse=True)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("buffer_mb", [0, 0.25, 2, 16])
@pytest.mark.parametrize("name", ["sd_toy", "sd_v14"])
def test_reuse_planner_matches_jax(name, buffer_mb, dtype_bytes):
    jl = JRP.unet_conv_layers(J_UNET_CONFIGS[name], dtype_bytes)
    tl = TRP.unet_conv_layers(UNET_CONFIGS[name], dtype_bytes)
    assert [dataclasses.astuple(l) for l in tl] == [dataclasses.astuple(l) for l in jl]
    buf = int(buffer_mb * MB)
    tp, jp = TRP.plan_layers(tl, buf), JRP.plan_layers(jl, buf)
    assert [dataclasses.astuple(p) for p in tp] == [dataclasses.astuple(p) for p in jp]
    assert TRP.traffic_summary(tp) == JRP.traffic_summary(jp)
    sizes = [buf // 2, buf, 2 * buf + 1]
    assert TRP.buffer_sweep(tl, sizes) == JRP.buffer_sweep(jl, sizes)


def test_pas_calibration_example_on_cpu_writes_a_profile_serve_loads(tmp_path, capsys):
    """The calibrate -> serve loop inside the port, at sd_toy and 8 steps."""
    path = str(tmp_path / "profile.npz")
    _example("torch_pas_calibration").main(
        ["--device", "cpu", "--timesteps", "8", "--prompts", "1", "--profile-out", path])
    out = capsys.readouterr().out
    assert "[4/4]" in out and "profile saved" in out
    profile, ts = TSS.load_profile(path)
    assert profile.scores.shape == (7, 6) and list(ts) == list(range(875, -1, -125))
    config = EngineConfig(n_lanes=2, max_steps=8, device="cpu", unet="sd_toy",
                          cache_mode="cross", profile=path, decode_images=False)
    policy = TCFG.build_engine(config).policy
    assert policy.bucket_factors == TP.profile_bucket_factors(profile, ts)


def test_quickstart_example_on_cpu(capsys):
    _example("torch_quickstart").main(["--device", "cpu", "--timesteps", "6"])
    out = capsys.readouterr().out
    assert "MAC reduction (Eq. 3)" in out and "cosine vs full sampler" in out


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_pas_calibration"])
def test_examples_refuse_a_missing_gpu_without_device_cpu(name, monkeypatch):
    mod = _example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main([])
