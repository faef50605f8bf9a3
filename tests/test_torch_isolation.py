"""repro_torch stands alone: it imports neither JAX nor the repro package,
and neither do the port's examples (``examples/torch_*.py``) nor its chip
smoke test (``chip_smoke.py``), whose HTTP server subprocess runs the port."""
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
EXAMPLES = sorted((SRC.parent / "examples").glob("torch_*.py"))
CHIP_SMOKE = SRC.parent / "chip_smoke.py"
#: test ids are file names; a later module that shares its name with an
#: older one is named with its package, so the older one keeps its id
QUALIFIED = {PKG / "core" / "metrics.py"}
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(MODULES)


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + EXAMPLES + [CHIP_SMOKE],
    ids=lambda p: f"{p.parent.name}/{p.name}" if p in QUALIFIED else p.name,
)
def test_no_source_file_imports_jax_or_repro(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M), path
    assert not re.search(r"^\s*(from repro[. ]|import repro\b)", text, re.M), path


def test_chip_smoke_starts_only_the_port():
    """Every module chip_smoke.py runs with ``python -m`` is the port's, and
    importing the script (not running it) loads no JAX and no repro."""
    text = CHIP_SMOKE.read_text()
    modules = re.findall(r'^P8_SERVER = "([\w.]+)"', text, re.M)
    assert modules == ["repro_torch.launch.serve"]
    assert re.findall(r'"-m", ([\w.]+)', text) == ["P8_SERVER"]
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(CHIP_SMOKE)!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env={"PATH": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
