"""The port's mesh costing (``repro_torch.launch.specs`` / ``dryrun``)
against the reference's.

* ``input_specs`` on both abstract meshes, for all 35 (arch x cell) cells,
  baseline and optimized at the reference's 8 GiB budget: shapes, dtypes,
  in / out specs and donated args equal, and each device's argument bytes
  equal the sum of ``NamedSharding.shard_shape`` over the leaves;
* ``_n_scan_units`` and ``collective_wire_seconds`` against the reference;
* the meta run: its FLOPs equal ``FlopCounterMode`` over a real CPU run,
  its memo changes nothing, and the two-point extrapolation equals the
  whole-depth count for every SMOKE arch;
* ``collectives_from_specs`` against a hand count;
* ``run_cell``'s result algebra against the reference's on stubbed costs,
  and the CLI in-process, writing the reference's key set.

The reference's ``launch/dryrun.py`` rewrites ``XLA_FLAGS`` when imported:
it is imported inside a fixture, after JAX's backend is up, and the
variable is restored after the test.
"""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP
from test_torch_pspecs import jax_flat, port_flat
from torch.utils.flop_counter import FlopCounterMode

from repro.common import sharding as RSH
from repro.configs import ARCH_IDS, cells_for, get_lm_config
from repro.launch import specs as RS
from repro_torch.common.sharding import Mesh
from repro_torch.common.tree import tree_map
from repro_torch.common.types import SHAPE_CELLS, ShapeCell
from repro_torch.configs import get_lm_config as port_config
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import specs as TS
from repro_torch.launch.steps import get_adapter
from repro_torch.optim import init_adamw

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
REF_BUDGET = 8 * 2**30  # the reference's infer_fsdp_budget (half a v5e)
SMALL = {"train": ShapeCell("train_s", 32, 4, "train"),
         "prefill": ShapeCell("prefill_s", 32, 2, "prefill"),
         "decode": ShapeCell("decode_s", 32, 4, "decode")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def ref_dryrun(monkeypatch):
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored after."""
    jax.devices()
    if "XLA_FLAGS" in os.environ:
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    import repro.launch.dryrun as RD

    return RD


def _port_cell(name: str) -> ShapeCell:
    return next(c for c in SHAPE_CELLS if c.name == name)


def _structs_once(monkeypatch):
    """Both packages' ``params_struct``, drawn once a config (the cells of
    an arch share one parameter tree)."""
    for mod in (RS, TS):
        def once(ad, orig=mod.params_struct, memo={}):
            if ad.cfg not in memo:
                memo[ad.cfg] = orig(ad)
            return memo[ad.cfg]

        monkeypatch.setattr(mod, "params_struct", once)


def _ref_arg_bytes(mesh, spec) -> int:
    leaves = jax.tree.leaves(spec.args)
    shardings = jax.tree.leaves(spec.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shardings)
    return sum(int(np.prod(s.shard_shape(x.shape))) * jnp.dtype(x.dtype).itemsize
               for x, s in zip(leaves, shardings))


@pytest.mark.parametrize("perf", ["baseline", "optimized"])
@pytest.mark.parametrize("shape,names", MESHES, ids=["16x16", "2x16x16"])
def test_input_specs_match_the_reference_on_every_cell(monkeypatch, shape, names, perf):
    _structs_once(monkeypatch)
    ref_mesh, mesh = AbstractMesh(shape, names), Mesh(shape, names)
    if perf == "optimized":
        ref_perf = RS.PerfConfig.optimized()
        port_perf = dataclasses.replace(TS.PerfConfig.optimized(), infer_fsdp_budget=REF_BUDGET)
    else:
        ref_perf, port_perf = RS.PerfConfig(), TS.PerfConfig(infer_fsdp_budget=REF_BUDGET)
    n = 0
    for arch in ARCH_IDS:
        for cell in cells_for(arch):
            try:
                ref = RS.input_specs(get_lm_config(arch, "full"), cell, ref_mesh, perf=ref_perf)
            finally:
                RSH.set_attn_kv_gather(False)
            got = TS.input_specs(port_config(arch, "full"), _port_cell(cell.name), mesh,
                                 perf=port_perf)
            where = (arch, cell.name)
            assert got.name == ref.name
            assert port_flat(got.args) == jax_flat(ref.args), where
            assert port_flat(got.in_shardings) == jax_flat(ref.in_shardings), where
            assert port_flat(got.out_shardings) == jax_flat(ref.out_shardings), where
            assert got.donate_argnums == ref.donate_argnums, where
            port_bytes = sum(TD.tree_shard_bytes(mesh, s, a)
                             for s, a in zip(got.in_shardings, got.args))
            assert port_bytes == _ref_arg_bytes(ref_mesh, ref), where
            if (arch, cell.name, shape, perf) == ("yi-6b", "train_4k", (16, 16), "baseline"):
                assert round(port_bytes / 2**30, 3) == 0.224
            n += 1
    assert n == 35


def test_perf_config_and_the_h100_fsdp_budget():
    """Field for field the reference's PerfConfig, but the "auto" budget is
    half an H100's memory: mixtral and qwen3, whose TP-sharded weights
    pass 8 GiB a device, drop the ZeRO-3 axis at inference there."""
    ref, port = RS.PerfConfig.optimized(), TS.PerfConfig.optimized()
    fields = [f.name for f in dataclasses.fields(RS.PerfConfig)]
    assert fields == [f.name for f in dataclasses.fields(TS.PerfConfig)]
    for f in fields:
        if f != "infer_fsdp_budget":
            assert getattr(port, f) == getattr(ref, f), f
    assert port.infer_fsdp_budget == TM.HBM_BYTES // 2 and ref.infer_fsdp_budget == REF_BUDGET
    mesh = TM.make_production_mesh()
    changed, kept_fsdp = [], []
    for arch in ARCH_IDS:
        cfg = port_config(arch, "full")
        cell = _port_cell("prefill_32k")
        at = {b: TS.input_specs(cfg, cell, mesh, perf=dataclasses.replace(
            port, infer_fsdp_budget=b)).in_shardings[0]["embed"]
            for b in (REF_BUDGET, port.infer_fsdp_budget)}
        if at[REF_BUDGET] != at[port.infer_fsdp_budget]:
            changed.append(arch)
            assert REF_BUDGET < 2 * cfg.param_count() // 16 <= port.infer_fsdp_budget
        if "data" in at[port.infer_fsdp_budget]:
            kept_fsdp.append(arch)
    assert changed == ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
    assert kept_fsdp == []


def test_scan_units_and_wire_seconds_match_the_reference(ref_dryrun):
    for arch in ARCH_IDS:
        for variant in ("smoke", "full"):
            assert (TD._n_scan_units(port_config(arch, variant))
                    == ref_dryrun._n_scan_units(get_lm_config(arch, variant)))
    rng = np.random.default_rng(0)
    for _ in range(20):
        coll = {k: int(rng.integers(0, 2**40)) for k in
                rng.choice(["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                            "collective-permute"], size=3, replace=False)}
        bw = float(rng.uniform(1e9, 1e12))
        assert TD.collective_wire_seconds(coll, bw) == ref_dryrun.collective_wire_seconds(coll, bw)


def _real(x: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point:
        return torch.randn(x.shape, dtype=x.dtype) * 0.1
    return torch.zeros(x.shape, dtype=x.dtype) if x.ndim == 0 else torch.randint(0, 8, x.shape,
                                                                                dtype=x.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_flops_equal_flop_counter_on_a_real_cpu_run(arch):
    """The meta count is ``FlopCounterMode`` over the same step run for real
    on the CPU (SMOKE config, small cells); the memo changes no count."""
    cfg = port_config(arch, "smoke")
    mesh = TM.make_host_mesh()
    for kind, cell in SMALL.items():
        spec = TS.input_specs(cfg, cell, mesh)
        counts = []
        for memo in (True, False) if kind == "train" else (True,):
            with TD.MetaCost(memo=memo) as m:
                TS.input_specs(cfg, cell, mesh).step_fn(*TD._run_args(spec, cell))
            counts.append((m.flops, m.bytes, m.peak))
        assert counts[0] == counts[-1], (kind, counts)
        torch.manual_seed(0)
        args = list(TD._run_args(spec, cell))
        args[0] = get_adapter(cfg).init(torch.Generator().manual_seed(0), "cpu")
        for i in range(1, len(args)):
            if isinstance(args[i], int):
                continue
            args[i] = (init_adamw(args[0]) if kind == "train" and i == 1
                       else tree_map(_real, args[i]))
        with FlopCounterMode(display=False) as fc:
            spec.step_fn(*args)
        assert counts[0][0] == fc.get_total_flops() > 0, kind


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_extrapolated_cost_equals_the_whole_depth_count(arch):
    """Every SMOKE arch, deepened to three units where it has fewer: the
    1-unit / 2-unit algebra gives the whole-depth FLOPs and bytes, and the
    output bytes, exactly."""
    mesh = Mesh((2, 2), ("data", "model"))
    base = port_config(arch, "smoke")
    cfg = base if TD._n_scan_units(base) >= 3 else TD._with_units(base, 3)
    assert TD._n_scan_units(cfg) >= 3
    for cell in SMALL.values():
        whole, m1 = TD.cell_costs(cfg, cell, mesh)
        extra, m2 = TD.cell_costs(cfg, cell, mesh, extrapolate=True)
        assert (m1, m2) == ("unrolled", "extrapolated")
        assert (whole.flops, whole.bytes, whole.output_bytes) == (
            extra.flops, extra.bytes, extra.output_bytes), (cfg.n_layers, cell.kind)
        assert whole.flops > 0 and whole.temp_bytes > 0


def _hand_param_bytes(cfg, ms, dp, dt):
    """(all-gathered, reduce-scattered, replicated) bytes a device holds of
    a dense transformer's parameters under the FSDP x TP layout."""
    L, d, q, kv, f, v = cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff, cfg.vocab_size
    fsdp_tp = L * (d * q + 2 * d * kv + q * d + 3 * d * f) + 2 * v * d  # both axes
    return fsdp_tp * dt // ms, fsdp_tp * dt // (ms * dp), (2 * L * d + d) * 4


def test_collectives_from_specs_against_a_hand_count():
    mesh = TM.make_production_mesh()
    # yi-6b train_4k: FSDP x TP, every weight over both axes, norms replicated
    cfg = port_config("yi-6b", "full")
    cell = _port_cell("train_4k")
    spec = TS.input_specs(cfg, cell, mesh)
    gathered, own, replicated = _hand_param_bytes(cfg, 16, 16, 2)
    rows = (256 // 16) * 4096  # tokens a device holds
    row_parallel = 2 * cfg.n_layers * rows * cfg.d_model * 2  # wo and w_out outputs, bf16
    want = {"all-gather": 2 * gathered, "reduce-scatter": own,
            "all-reduce": replicated + 2 * row_parallel}
    assert TD.collectives_from_specs(cfg, cell, mesh, spec.in_shardings[0]) == want
    # mixtral-8x22b decode_32k: 8 experts over 16 -> TP experts; weights
    # gathered once; wo and every expert's w_out row-parallel at 8 tokens a
    # device, each expert's buffer one slot deep (capacity min(8, 1))
    cfg = port_config("mixtral-8x22b", "full")
    cell = _port_cell("decode_32k")
    spec = TS.input_specs(cfg, cell, mesh)
    L, d, q, kv, e, f, v = (cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                            cfg.moe.num_experts, cfg.moe.d_expert, cfg.vocab_size)
    gathered = (L * (d * q + 2 * d * kv + q * d + 3 * e * d * f) + 2 * v * d) * 2 // 16
    gathered += L * d * e * 4  # the float32 router, gathered whole
    b_loc = 128 // 16
    want = {"all-gather": gathered,
            "all-reduce": L * (b_loc * d * 2 + b_loc * e * 1 * d * 2)}
    assert TD.collectives_from_specs(cfg, cell, mesh, spec.in_shardings[0]) == want


class _CtxMesh:
    """An abstract mesh the reference's ``run_cell`` can enter."""

    def __init__(self, shape, names):
        self.m = AbstractMesh(shape, names)
        self.size = math.prod(shape)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Compiled:
    def __init__(self, mem):
        self.mem = mem

    def memory_analysis(self):
        return self.mem


def _drive_both(monkeypatch, ref_dryrun, arch, cell, multi_pod, extrapolate):
    """Both ``run_cell``s on the same stubbed costs: the reference's
    compile and HLO cost, and the port's meta run and collective model.
    The port's argument bytes are its own (real), and fed to the stub."""
    shape, names = MESHES[multi_pod]
    chips = math.prod(shape)
    spec = TS.input_specs(port_config(arch, "smoke"), _port_cell(cell), Mesh(shape, names))
    arg = sum(TD.tree_shard_bytes(Mesh(shape, names), s, a)
              for s, a in zip(spec.in_shardings, spec.args))
    mem = type("Mem", (), {"argument_size_in_bytes": arg, "output_size_in_bytes": 777,
                           "temp_size_in_bytes": 12345})()
    points = [(3.0e12, 5.0e10, {"all-gather": 4096, "all-reduce": 1000}),
              (5.5e12, 7.0e10, {"all-gather": 4096, "all-reduce": 1000})]
    calls = iter(points * 2)
    monkeypatch.setattr(ref_dryrun, "make_production_mesh",
                        lambda multi_pod=False: _CtxMesh(shape, names))
    monkeypatch.setattr(ref_dryrun, "_compile_cell", lambda *a, **k: _Compiled(mem))
    monkeypatch.setattr(ref_dryrun, "_cost_tuple", lambda compiled: next(calls))

    def step_cost(spec, c, mesh, _pts=iter(points)):
        f, b, _ = next(_pts)
        return TD.StepCost(flops=f * chips, bytes=b * chips, temp_bytes=12345 * chips,
                           output_bytes=777)

    monkeypatch.setattr(TD, "_step_cost", step_cost)
    monkeypatch.setattr(TD, "collectives_from_specs", lambda *a, **k: dict(points[0][2]))
    kw = dict(multi_pod=multi_pod, variant="smoke", skip_unrolled=multi_pod,
              extrapolate=extrapolate)
    ref = ref_dryrun.run_cell(arch, cell, **kw)
    ref_dryrun.set_activation_mesh(None)
    return ref, TD.run_cell(arch, cell, **kw)


@pytest.mark.parametrize("multi_pod,extrapolate", [(False, False), (False, True), (True, False)],
                         ids=["unrolled", "extrapolated", "multipod-skipped"])
def test_run_cell_result_algebra_matches_the_reference(monkeypatch, ref_dryrun, multi_pod,
                                                       extrapolate):
    ref, port = _drive_both(monkeypatch, ref_dryrun, "musicgen-medium", "train_4k", multi_pod,
                            extrapolate)
    assert list(port) == list(ref)
    timings = {"compile_s", "compile_unrolled_s"}
    for key in set(ref) - timings - {"roofline_s", "bottleneck"}:
        assert port[key] == ref[key], key
    scale = {"compute": ref_dryrun.PEAK_FLOPS_BF16 / TM.PEAK_FLOPS_BF16,
             "memory": ref_dryrun.HBM_BW / TM.HBM_BW,
             "collective": ref_dryrun.ICI_BW_PER_LINK / TM.LINK_BW}
    for term, s in scale.items():
        assert port["roofline_s"][term] == pytest.approx(ref["roofline_s"][term] * s, rel=1e-12)
    assert port["bottleneck"] == max(port["roofline_s"], key=port["roofline_s"].get)


def test_cli_writes_the_reference_key_set(monkeypatch, ref_dryrun, tmp_path, capsys):
    ref, _ = _drive_both(monkeypatch, ref_dryrun, "gemma3-1b", "decode_32k", False, False)
    monkeypatch.undo()
    TD.main(["--arch", "gemma3-1b", "--cell", "decode_32k", "--variant", "smoke", "--extrapolate",
             "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[dryrun] OK   gemma3-1b/decode_32k/16x16: compile=" in out
    assert "[dryrun] 1/1 cells passed" in out
    res = json.loads((tmp_path / "gemma3-1b__decode_32k__sp.json").read_text())
    assert set(res) == set(ref) | {"perf"}
    assert set(res["memory"]) == set(ref["memory"]) and set(res["roofline_s"]) == set(
        ref["roofline_s"])
    assert res["ok"] and res["cost_mode"] == "extrapolated" and res["perf"] == "baseline"
    assert res["flops_per_device"] > 0 and res["memory"]["argument_bytes"] > 0


def test_shardings_hold_refuses_an_uneven_tiling():
    """``_check_cell`` (the rolled compile's counterpart) names the leaf
    whose spec does not tile it: a d_ff of 162 over a 4-way model axis."""
    cfg = dataclasses.replace(port_config("yi-6b", "smoke"), d_ff=162)
    mesh = Mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match=r"\['mlp'\]\['w_gate'\].*does not divide evenly"):
        TD._check_cell(cfg, SMALL["train"], mesh, None)
    TD._check_cell(port_config("yi-6b", "smoke"), SMALL["train"], mesh, None)
