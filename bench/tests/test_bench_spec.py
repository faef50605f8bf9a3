"""BENCHMARK.json and the files it names: every cell, configuration, mix,
limit and metric loads by name, the file keeps to the benchmark's
format rules, and a new cell, configuration, mix or metric is found by adding
files and entries alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench import spec
from bench.tests.conftest import ROOT

BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert BM["command"] == ["python3", "bench/run.py"] and BM["paths"] == ["bench"]
    assert 1 <= BM["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert c.config["name"] == c.config_name
    assert c.model.__name__ == "bench_model_" + c.config.get("model", spec.DEFAULT_MODEL)
    assert set(c.limits) == {"latent_err", "image_err"}
    assert 0 < min(c.limits.values()) and max(c.limits.values()) < 1
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m.moves in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BM["end_to_end"] + BM["per_layer"]])
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.reader(metric))


def test_names_units_and_entries_follow_the_format():
    metrics = BM["end_to_end"] + BM["per_layer"]
    for group in (BM["configs"], BM["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
        assert any(w["config"] == c["name"] for w in BM["workloads"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BM["workloads"]}) == len(BM["workloads"])
    e2e = {m["name"] for m in BM["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BM["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_new_cell_configuration_mix_and_metric_are_found_from_new_files(tmp_path):
    """Copy the benchmark, then add a configuration, a mix, a cell, its
    limits and a metric as new files plus entries: all load, and no file
    that was there changed."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "sd_v14.json").read_text())
    (b / "configs" / "sd_v14_copy.json").write_text(json.dumps(dict(cfg, name="sd_v14_copy")))
    mix = json.loads((b / "mixes" / "tiers.backlog.json").read_text())
    (b / "mixes" / "draft.backlog.json").write_text(json.dumps(dict(mix, tiers={"draft": 1})))
    (b / "limits" / "sd_v14_copy.draft.backlog.json").write_text(
        json.dumps({"latent_err": 1e-3, "image_err": 1e-3}))
    (b / "metrics" / "toy_count.py").write_text(
        "def read(record):\n    return float(len(record['requests']))\n")
    bm["configs"].append(dict(bm["configs"][0], name="sd_v14_copy",
                              file="bench/configs/sd_v14_copy.json"))
    bm["workloads"].append(dict(name="sd_v14_copy.draft.backlog", config="sd_v14_copy",
                                traffic="draft.backlog", chips=1, why="toy"))
    bm["per_layer"].append(dict(name="toy_count", unit="requests", better="higher",
                                source="program_counter", layer="driver", moves="images_per_s",
                                workloads=["sd_v14_copy.draft.backlog"]))
    bm["end_to_end"][0]["workloads"].append("sd_v14_copy.draft.backlog")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    cell = spec.load_cell("sd_v14_copy.draft.backlog", tmp_path, b)
    assert cell.mix["tiers"] == {"draft": 1} and cell.config["name"] == "sd_v14_copy"
    assert [m.name for m in cell.per_layer] == ["toy_count"]
    assert spec.reader("toy_count", b)({"requests": {1: {}, 2: {}}}) == 2.0
    assert {p: p.read_bytes() for p in before} == before
