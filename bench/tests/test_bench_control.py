"""The check's control, on the card: at each cell's own size and load, the
check (``bench/check.py``) passes the program's outputs and fails the
reference computed in TF32 put in the program's place.  Needs a CUDA
card; it skips here otherwise.  ``bench/calibrate.py`` takes the same
readings over many seeds; this test takes one seed a cell, with a window
in which as many requests finish as a run checks."""
from __future__ import annotations

import json

import pytest

from bench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
WINDOW_S = 20.0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    from bench import serve, spec
    from bench.calibrate import control_readings
    from bench.run import fixed_caches
    from bench.traffic import Traffic

    fixed_caches(ROOT)
    c = spec.load_cell(cell)
    seed = 20_260_001
    record = serve.run_cell(c, seed, WINDOW_S, False)
    r = control_readings(c, record, Traffic(c.mix, c.config, seed, c.model), "cuda")
    print(json.dumps(dict(cell=cell, seed=seed, **r)))
    assert len(r["checked"]) == c.mix["check"]["sample"], r
    assert r["program_correct"], r
    assert not r["control_correct"], r
