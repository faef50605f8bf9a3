"""What a cell is, read from data: ``BENCHMARK.json`` at the checkout's root
names the cells, and each part of a cell is a file of its own found by
its name.

* configuration ``<c>``: ``bench/configs/<c>.json``;
* traffic mix ``<t>``: ``bench/mixes/<t>.json``;
* metric ``<m>``: ``bench/metrics/<m>.py``, a module with ``read(run) ->
  float | None`` (None: nothing to read in this run);
* the limits of a cell's output check: ``bench/limits/<cell>.json``;
* model ``<m>``: ``bench/reference/<m>.py``, the plain reference of the
  configurations whose file names it under ``"model"`` (``"sd"`` where
  the key is absent), loaded by file path.  Its contract is in the
  docstring of ``bench/reference/sd.py``: weight layouts, conditioning,
  U-Net, sampler, VAE decode, PAS plans and precision.

Adding a cell, a configuration, a model, a mix or a metric adds files and
entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Callable

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: the model of a configuration whose file names none
DEFAULT_MODEL = "sd"


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    end_to_end: bool
    workloads: tuple[str, ...] | None  # None: every cell that reports ``moves``
    moves: str | None = None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]
    model: ModuleType  # the configuration's model module


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file missing: {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _metrics(entries: list[dict], end_to_end: bool) -> list[Metric]:
    return [
        Metric(m["name"], m["unit"], m["better"], m["source"], end_to_end,
               tuple(m["workloads"]) if "workloads" in m else None, m.get("moves"))
        for m in entries
    ]


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    spec = load_benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in _metrics(spec["end_to_end"], True)
           if m.workloads is None or name in m.workloads]
    reported = {m.name for m in e2e}
    layer = [m for m in _metrics(spec["per_layer"], False)
             if (name in m.workloads if m.workloads is not None else m.moves in reported)]
    config = _json(bench / "configs" / f"{w['config']}.json")
    return Cell(
        name=name, config_name=w["config"], traffic=w["traffic"], chips=int(w["chips"]),
        config=config, mix=_json(bench / "mixes" / f"{w['traffic']}.json"),
        limits=_json(bench / "limits" / f"{name}.json"),
        end_to_end=tuple(e2e), per_layer=tuple(layer),
        model=load_model(config.get("model", DEFAULT_MODEL), bench),
    )


def _load(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_model(model: str, bench: Path = BENCH) -> ModuleType:
    """The model module ``bench/reference/<model>.py``."""
    path = bench / "reference" / f"{model}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no model module {model!r}: {path} is missing")
    return _load(path, "bench_model_" + model.replace(".", "_").replace("-", "_"))


def reader(metric: str, bench: Path = BENCH) -> Callable[[dict], Any]:
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    return _load(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_")).read
