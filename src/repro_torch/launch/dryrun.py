"""Mesh costing: every (arch x shape x mesh) cell's layout, memory and
roofline, on ``meta`` tensors.

The port's copy of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 placeholder devices; the port runs no
SPMD program, so each pass has a torch form, and none touches a card:

* **Shardings hold.**  ``input_specs`` builds the args as ``meta`` trees
  with their partition specs, and every spec must tile its leaf evenly
  (``shard_shape``).  This is the rolled compile's counterpart;
  ``compile_s`` times it.
* **Memory.**  ``argument_bytes`` and ``output_bytes`` are each device's
  exact shard bytes of the args and of the step's outputs.  The step runs
  once on ``meta`` to give the outputs, and ``temp_bytes`` is the
  high-water mark of the bytes it allocated that were alive at once (the
  arguments are not among them), divided by the chips: an *estimate* of
  each device's working set under a perfect partition of the eager step,
  which frees a tensor when its last reference goes.  ``peak_bytes`` is
  the reference's ``temp + argument``.
* **Cost.**  ``flops_per_device`` is ``FlopCounterMode``'s count over the
  whole step on ``meta`` (a train step includes the backward and the
  recomputation of each checkpointed unit), divided by the chips: the
  perfect-partition model.  ``bytes_per_device`` is the input plus output
  bytes of every aten op the step dispatches on ``meta``, view ops
  skipped, divided by the chips: the port runs eager with no fusion, so
  this is what it moves.  ``cost_mode`` is "unrolled" when the step runs
  at its whole depth (every layer of the loop runs), "extrapolated"
  (``--extrapolate``) when a 1-unit and a 2-unit copy of the config run
  and the reference's algebra ``c1 + (n - 1) * (c2 - c1)`` gives the whole
  depth (and the output bytes; a train step's temp bytes too, an
  inference step's are the larger of the two), and "skipped"
  (``--skip-unrolled``, and every multi-pod cell) when only the memory is
  wanted, which then comes from the two short runs.
* **Collectives.**  There is no HLO to parse.  :func:`collectives_from_specs`
  is a model of the layout, not a parse of a compiled program, in the
  reference's kinds and output-bytes convention, so that
  :func:`collective_wire_seconds` applies unchanged.

``model_flops``, the roofline terms and ``bottleneck`` keep the
reference's formulas, with the H100 constants of ``launch/mesh.py``.

Usage (no GPU needed, by design)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun

Flags: ``--multipod`` (2x16x16 mesh instead of 16x16), ``--both-meshes``,
``--variant smoke|full``, ``--opt`` (the optimized ``PerfConfig``),
``--extrapolate``, ``--skip-unrolled``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common.sharding import (
    Mesh,
    P,
    batch_axes,
    dp_size,
    entry_axes,
    is_spec,
    shard_bytes,
    shard_shape,
    tree_shard_bytes,
)
from repro_torch.common.tree import tree_leaves, tree_leaves_with_path
from repro_torch.common.types import SHAPE_CELLS, LMConfig, ShapeCell
from repro_torch.configs import ARCH_IDS, cells_for, get_lm_config
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, make_production_mesh
from repro_torch.launch.specs import CellSpec, PerfConfig, input_specs, params_struct
from repro_torch.launch.steps import get_adapter
from repro_torch.models.layers import moe_capacity


def collective_wire_seconds(coll: dict[str, int], link_bw: float) -> float:
    """Ring-collective wire-time model per device.

    all-reduce moves ~2x its bytes over the slowest link (reduce-scatter +
    all-gather phases); the others move ~1x their output bytes.
    """
    t = 0.0
    for kind, nbytes in coll.items():
        factor = 2.0 if kind == "all-reduce" else 1.0
        t += factor * nbytes / link_bw
    return t


def _n_scan_units(cfg) -> int:
    """Layer-scan trip count (full units; the tail is outside)."""
    if cfg.family in ("ssm", "hybrid"):
        return cfg.n_layers
    return cfg.n_layers // len(cfg.pattern)


def _with_units(cfg: LMConfig, units: int) -> LMConfig:
    """``cfg`` cut to ``units`` full units, its tail kept."""
    if cfg.family in ("ssm", "hybrid"):
        return dataclasses.replace(cfg, n_layers=units)
    u = len(cfg.pattern)
    return dataclasses.replace(cfg, n_layers=units * u + cfg.n_layers % u)


# ---------------------------------------------------------------------------
# The meta run: FLOPs, bytes moved and live bytes of one step
# ---------------------------------------------------------------------------

#: size queries FlopCounterMode leaves to the tensor (no op runs); a name
#: this torch lacks is skipped
_QUERIES = {
    getattr(getattr(ns, op, None), overload, None) for ns, op, overload in (
        (torch.ops.aten, "sym_is_contiguous", "default"),
        (torch.ops.aten, "is_contiguous", "default"),
        (torch.ops.aten, "is_contiguous", "memory_format"),
        (torch.ops.aten, "is_strides_like_format", "default"),
        (torch.ops.aten, "is_non_overlapping_and_dense", "default"),
        (torch.ops.aten, "size", "default"), (torch.ops.aten, "sym_size", "default"),
        (torch.ops.aten, "stride", "default"), (torch.ops.aten, "sym_stride", "default"),
        (torch.ops.aten, "storage_offset", "default"),
        (torch.ops.aten, "sym_storage_offset", "default"),
        (torch.ops.aten, "numel", "default"), (torch.ops.aten, "sym_numel", "default"),
        (torch.ops.aten, "dim", "default"), (torch.ops.prim, "layout", "default"),
    )
} - {None}
_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format)


class _Unkeyed(Exception):
    pass


def _sig(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Unkeyed
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    if isinstance(x, _SCALARS):
        return (type(x), x)
    raise _Unkeyed


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class MetaCost(TorchDispatchMode):
    """Counts a step run on ``meta`` tensors.

    ``flops``: ``FlopCounterMode``'s count (the same decompositions and the
    same formulas, ``torch.utils.flop_counter.flop_registry``).  ``bytes``:
    input plus output bytes of every non-view op on ``meta``.  ``peak``:
    the most bytes of ``meta`` storage this mode allocated that were alive
    at once.  An op seen before with the same argument metadata gives its
    outputs from a memo (``torch.empty_strided``), since on ``meta`` an
    op's outputs, FLOPs and bytes depend on nothing else; the meta kernels
    of elementwise ops are Python references that take most of a run
    (``memo=False`` runs every op)."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.memo = memo
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._memo: dict[Any, tuple] = {}
        self._decomposes: dict[Any, bool] = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def _alloc(self, t: torch.Tensor, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        dec = self._decomposes.get(func)
        if dec is None:
            dk = torch._C.DispatchKey.CompositeImplicitAutograd
            dec = dk in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), dk)
            self._decomposes[func] = dec
        if dec and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        aliasing = any(r.alias_info is not None for r in func._schema.returns)
        try:
            key = (None if aliasing or not self.memo
                   else (func, _sig(args), _sig(tuple(sorted(kwargs.items())))))
        except _Unkeyed:
            key = None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            metas, flops, nbytes, single = hit
            outs = [torch.empty_strided(sh, st, dtype=dt, device="meta") for sh, st, dt, _ in metas]
            for o, m in zip(outs, metas):
                self._alloc(o, m[3])
            self.flops += flops
            self.bytes += nbytes
            return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        self.flops += flops
        if func.is_view:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        on_meta = all(t.device.type == "meta" for t in ins + outs)
        nbytes = sum(_nbytes(t) for t in ins + outs) if on_meta else 0
        self.bytes += nbytes
        if aliasing or not on_meta:
            return out
        metas = [(o.shape, o.stride(), o.dtype, o.untyped_storage().nbytes()) for o in outs]
        for o, m in zip(outs, metas):
            self._alloc(o, m[3])
        single = isinstance(out, torch.Tensor)
        if key is not None and (single or (isinstance(out, tuple) and len(outs) == len(out))):
            self._memo[key] = (metas, flops, nbytes, single)
        return out


@dataclasses.dataclass
class StepCost:
    """One step's global counts (before the division by the chips)."""

    flops: float
    bytes: float
    temp_bytes: float
    output_bytes: float  # per device, from the out specs


def _run_args(spec: CellSpec, cell: ShapeCell) -> tuple:
    """The step's args; a decode step runs at the last position of its
    cache (the reference's position is a traced scalar: every position
    runs the same program, and here every position the same ops)."""
    if cell.kind == "decode":
        return spec.args[:-1] + (cell.seq_len - 1,)
    return spec.args


def _step_cost(spec: CellSpec, cell: ShapeCell, mesh: Mesh) -> StepCost:
    """Run ``spec``'s step once on ``meta`` and count it."""
    with MetaCost() as m:
        out = spec.step_fn(*_run_args(spec, cell))
    return StepCost(flops=float(m.flops), bytes=float(m.bytes), temp_bytes=float(m.peak),
                    output_bytes=float(tree_shard_bytes(mesh, spec.out_shardings, out)))


def _check_cell(cfg: LMConfig, cell: ShapeCell, mesh: Mesh, perf) -> CellSpec:
    """Build the cell's specs and check that every spec tiles its leaf
    evenly (raises ``ValueError`` where one does not)."""
    spec = input_specs(cfg, cell, mesh, perf=perf)
    for specs, tree in zip(spec.in_shardings, spec.args):
        for (path, s), x in zip(tree_leaves_with_path(specs, is_leaf=is_spec), tree_leaves(tree)):
            try:
                shard_shape(mesh, s, x.shape)
            except ValueError as e:
                raise ValueError(f"{spec.name} {path}: {e}") from None
    return spec


def _extrapolate(c1: float, c2: float, n: int) -> float:
    return c1 + (n - 1) * max(c2 - c1, 0.0)


def cell_costs(cfg: LMConfig, cell: ShapeCell, mesh: Mesh, perf=None, *,
               extrapolate: bool = False) -> tuple[StepCost, str]:
    """(global step counts, cost mode) of a cell: the whole depth, or the
    two-point extrapolation from a 1-unit and a 2-unit copy of ``cfg``."""
    if not extrapolate:
        return _step_cost(input_specs(cfg, cell, mesh, perf=perf), cell, mesh), "unrolled"
    n = _n_scan_units(cfg)
    c1, c2 = (_step_cost(input_specs(_with_units(cfg, u), cell, mesh, perf=perf), cell, mesh)
              for u in (1, 2))
    # a train step keeps each unit's checkpointed input and each unit's
    # gradients until its end: its high-water mark grows unit by unit; an
    # inference step frees a unit's activations before the next, so its
    # high-water mark does not grow with depth
    temp = (_extrapolate(c1.temp_bytes, c2.temp_bytes, n) if cell.kind == "train"
            else max(c1.temp_bytes, c2.temp_bytes))
    return StepCost(flops=_extrapolate(c1.flops, c2.flops, n),
                    bytes=_extrapolate(c1.bytes, c2.bytes, n), temp_bytes=temp,
                    output_bytes=_extrapolate(c1.output_bytes, c2.output_bytes, n)), "extrapolated"


# ---------------------------------------------------------------------------
# Collectives, from the layout
# ---------------------------------------------------------------------------

#: parameter leaves that are the right operand of a product ``x @ W``
#: (contraction over W's second-to-last dim)
_PRODUCTS = frozenset({"wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out", "w_down", "w_xdb",
                       "w_dt", "w_igate", "w_fgate", "w_ogate", "router", "lm_head"})


def _names(spec: P) -> set[str]:
    return {a for e in spec for a in entry_axes(e)}


def _leaf_name(path: str) -> str:
    return path.rsplit("[", 1)[-1].strip("]'")


def collectives_from_specs(cfg: LMConfig, cell: ShapeCell, mesh: Mesh, pspecs: Any,
                           perf=None) -> dict[str, int]:
    """Each device's collective bytes in one step, modelled from the layout.

    A model of the layout, not a parse of a compiled program.  Output
    bytes per device, by the reference's kinds:

    * all-gather: each FSDP-sharded parameter (its spec names "data") is
      gathered over "data" to its model-sharded shape, once per forward
      and twice in a train step (the backward gathers it again);
    * reduce-scatter: each FSDP-sharded parameter's gradient, to its shard;
    * all-reduce: the gradient shard of each leaf replicated over a batch
      axis; and the output of each product whose contraction dim the specs
      put on "model" (the row-parallel products), at that device's batch,
      once per forward and twice in a train step (the backward's input
      gradient too);
    * all-to-all: the dispatch and the combine of each MoE layer in
      expert-parallel mode (the experts over "model"), at that device's
      batch, twice as many in a train step.

    Not modelled: the loss's scalar reduction, the vocab-sharded embedding
    gather, and the reductions of a sequence-sharded decode cache.
    ``perf`` is accepted for the reference's signature; the layout it
    chooses is already in ``pspecs``.
    """
    del perf
    train = cell.kind == "train"
    passes = 2 if train else 1
    ba = batch_axes(mesh)
    dp = dp_size(mesh)
    b_loc = cell.global_batch // dp if (cell.global_batch % dp == 0
                                        and cell.global_batch >= dp) else cell.global_batch
    s_tok = 1 if cell.kind == "decode" else cell.seq_len
    params = params_struct(get_adapter(cfg))
    coll = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0, "all-to-all": 0}
    for (path, spec), x in zip(tree_leaves_with_path(pspecs, is_leaf=is_spec), tree_leaves(params)):
        names = _names(spec)
        own = shard_bytes(mesh, spec, x)
        if "data" in names:
            gathered = P(*(tuple(a for a in entry_axes(e) if a != "data") for e in spec))
            coll["all-gather"] += passes * shard_bytes(mesh, gathered, x)
            if train:
                coll["reduce-scatter"] += own
        if train and any(a not in names for a in ba):
            coll["all-reduce"] += own
        name = _leaf_name(path)
        if name not in _PRODUCTS or x.ndim < 2:
            continue
        moe = "['moe']" in path
        stack = x.shape[0] if "['blocks']" in path else 1
        if moe:
            cap = min(moe_capacity(cfg.moe, s_tok), s_tok)
            rows = b_loc * cfg.moe.num_experts * cap
        else:
            rows = b_loc * s_tok
        act = rows * x.shape[-1] * x.element_size() * stack
        if len(spec) >= 2 and spec[-2] == "model":
            coll["all-reduce"] += passes * act
        if moe and name == "w_out" and spec[-3] == "model":
            coll["all-to-all"] += 2 * passes * act
    return {k: int(v) for k, v in coll.items() if v}


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------


def cost_cell(cfg: LMConfig, cell: ShapeCell, mesh: Mesh, *, perf=None,
              skip_unrolled: bool = False, extrapolate: bool = False) -> dict:
    """The reference's result for one cell, without its naming keys."""
    n_chips = mesh.size
    t0 = time.time()
    spec = _check_cell(cfg, cell, mesh, perf)
    t_compile = time.time() - t0
    arg_bytes = sum(tree_shard_bytes(mesh, s, a) for s, a in zip(spec.in_shardings, spec.args))

    t1 = time.time()
    cost, cost_mode = cell_costs(cfg, cell, mesh, perf,
                                 extrapolate=extrapolate or skip_unrolled)
    t_unroll = time.time() - t1
    flops = bytes_accessed = 0.0
    coll: dict[str, int] = {}
    if skip_unrolled:
        cost_mode = "skipped"
    else:
        flops = cost.flops / n_chips
        bytes_accessed = cost.bytes / n_chips
        coll = collectives_from_specs(cfg, cell, mesh, spec.in_shardings[0], perf)
    coll_total = sum(coll.values())
    temp = int(cost.temp_bytes // n_chips)

    # analytic MODEL_FLOPS (6*N_active*D train / 2*N_active*D inference;
    # attention score FLOPs excluded) for the "useful compute" ratio.
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        model_flops = 6 * n_active * cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        model_flops = 2 * n_active * cell.global_batch * cell.seq_len
    else:  # decode: one new token per sequence
        model_flops = 2 * n_active * cell.global_batch
    model_flops_per_device = model_flops / n_chips

    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_accessed / HBM_BW
    t_coll = collective_wire_seconds(coll, LINK_BW)
    return {
        "chips": n_chips,
        "ok": True,
        "compile_s": round(t_compile, 1),
        "compile_unrolled_s": round(t_unroll, 1),
        "cost_mode": cost_mode,
        "flops_per_device": flops,
        "model_flops_per_device": model_flops_per_device,
        "model_flops_ratio": model_flops_per_device / flops if flops else 0.0,
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_total,
        "collectives": coll,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": int(cost.output_bytes),
            "temp_bytes": temp,
            "peak_bytes": temp + arg_bytes,
        },
        "roofline_s": {
            "compute": t_compute,
            "memory": t_memory,
            "collective": t_coll,
        },
        "bottleneck": max(
            [("compute", t_compute), ("memory", t_memory), ("collective", t_coll)],
            key=lambda kv: kv[1],
        )[0],
    }


def run_cell(
    arch: str, cell_name: str, *, multi_pod: bool, variant: str = "full",
    skip_unrolled: bool = False, perf=None, extrapolate: bool = False,
) -> dict:
    cfg = get_lm_config(arch, variant)
    cell = next(c for c in SHAPE_CELLS if c.name == cell_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = cost_cell(cfg, cell, mesh, perf=perf, skip_unrolled=skip_unrolled,
                    extrapolate=extrapolate)
    head = {"arch": arch, "cell": cell_name, "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": res.pop("chips"), "variant": variant}
    return head | res


def _job(arch: str, cell: str, mp: bool, args) -> dict:
    """One cell of ``main``'s sweep: its result, or its failure recorded."""
    perf = PerfConfig.optimized() if args.opt else None
    try:
        res = run_cell(
            arch, cell, multi_pod=mp, variant=args.variant,
            skip_unrolled=args.skip_unrolled or mp, perf=perf,
            extrapolate=args.extrapolate,
        )
        res["perf"] = "optimized" if args.opt else "baseline"
    except Exception as e:  # noqa: BLE001 — record and continue
        res = {"arch": arch, "cell": cell, "mesh": "2x16x16" if mp else "16x16",
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    return res


def _worker_init() -> None:
    torch.set_num_threads(1)


def _slow_first(job: tuple[str, str, bool]) -> tuple:
    """Hand the costliest runs to the workers first: hymba's selective scan
    walks every position, and a train or prefill step runs the whole
    sequence."""
    cfg = get_lm_config(job[0])
    kind = next(c.kind for c in SHAPE_CELLS if c.name == job[1])
    return (cfg.family != "hybrid", kind == "decode", cfg.moe is None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--cell", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="full", choices=["full", "smoke"])
    ap.add_argument("--out", default=None, help="directory for per-cell JSON results")
    ap.add_argument(
        "--skip-unrolled", action="store_true",
        help="layout and memory only (no cost pass); used for the multi-pod "
        "mesh where the roofline table is not derived",
    )
    ap.add_argument(
        "--extrapolate", action="store_true",
        help="two-point (1-unit / 2-unit) cost extrapolation instead of the "
        "whole-depth run",
    )
    ap.add_argument(
        "--opt", action="store_true",
        help="use the optimized PerfConfig (chunked CE, inference weight "
        "layout, flash-decoding cache sharding) instead of the "
        "paper-faithful baseline",
    )
    ap.add_argument(
        "--jobs", type=int, default=1,
        help="cost this many cells at once, each in a process of its own "
        "(the meta runs are single-threaded host work)",
    )
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, c.name) for a in ARCH_IDS for c in cells_for(a)]
    else:
        if not (args.arch and args.cell):
            ap.error("--arch and --cell (or --all)")
        cells = [(args.arch, args.cell)]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    jobs = [(arch, cell, mp) for arch, cell in cells for mp in meshes]

    if args.jobs > 1 and len(jobs) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(min(args.jobs, len(jobs)), initializer=_worker_init,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {job: pool.submit(_job, *job, args) for job in sorted(jobs, key=_slow_first)}
            results = [futures[job].result() for job in jobs]
    else:
        results = [_job(*job, args) for job in jobs]

    for (arch, cell, mp), res in zip(jobs, results):
        tag = f"{arch}/{cell}/{'2x16x16' if mp else '16x16'}"
        if res["ok"]:
            print(
                f"[dryrun] OK   {tag}: compile={res['compile_s']}s "
                f"peak={res['memory']['peak_bytes']/2**30:.2f}GiB "
                f"bottleneck={res['bottleneck']}"
            )
            if res["collectives"]:
                terms = " ".join(f"{k}={v / 2**20:.1f}MiB"
                                 for k, v in sorted(res["collectives"].items()))
                print(f"[dryrun]      collectives per device: {terms}")
        else:
            print(f"[dryrun] FAIL {tag}: {res['error']}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = "mp" if mp else "sp"
            if args.opt:
                suffix += "_opt"
            fn = f"{arch}__{cell}__{suffix}.json".replace("/", "_")
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(res, f, indent=1)
    n_ok = sum(r.get("ok") for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells passed")
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
