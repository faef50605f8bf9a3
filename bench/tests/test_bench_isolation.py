"""What the benchmark loads: neither JAX nor the JAX package anywhere, and
nothing of the program under the reference.  Module names are compared by
their whole top-level name, so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import importlib, pathlib
for m in ("bench.run", "bench.serve", "bench.check", "bench.trace", "bench.calibrate",
          "bench.flops", "bench.spec", "bench.traffic", "bench.counts"):
    importlib.import_module(m)
from bench import serve, spec
serve.program_modules()
for p in sorted(pathlib.Path({root!r}, "bench", "metrics").glob("*.py")):
    spec.reader(p.stem)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path[:0] = [{root!r}]
import bench.reference.sd, bench.reference.weights
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_harness_and_program_load_no_jax():
    names = _top_level(HARNESS)
    assert "repro_torch" in names and "bench" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_sources_import_only_torch(path):
    tree = ast.parse(path.read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_run_without_the_program_prints_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and bench/ exits non-zero and
    prints no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "sd_v14.tiers.backlog", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode != 0
    assert not out.stdout.strip()
