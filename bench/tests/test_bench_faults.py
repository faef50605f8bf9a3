"""A run with the timed path broken underneath comes out not correct.

Each test drives the harness as a run does (``serve.run_cell`` then
``check.check``), past the look for a card, and plants one fault in the
program: a micro-step that leaves the latents unchanged, half of the lanes
left out of the step, and an answer altered where the engine produces it.
At the toy configuration on the CPU the sound run comes out correct and
each broken one does not; the tests marked ``cuda`` plant the first two
faults at a cell's own size on the card (they skip here)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench import check, serve, spec
from bench.tests.conftest import ROOT
from bench.traffic import Traffic

SEED = 2**31 + 17
WINDOW_S = 2.5
#: the cell and window of the faults planted on the card
CARD_CELL = "sd_v14.tiers.backlog"
CARD_WINDOW_S = 20.0


def _run(root, cell="toy.tiers.backlog"):
    c = spec.load_cell(cell, root, root / "bench")
    record = serve.run_cell(c, SEED, WINDOW_S, False, device="cpu", backend="eager")
    return check.check(c, record, Traffic(c.mix, c.config, SEED, c.model), "cpu")


def _patch_step(monkeypatch, keep):
    """Wrap the program's micro-step: ``keep(state, x_before)`` undoes part
    of each step's work."""
    from repro_torch.serving import lanes

    build = lanes.make_micro_step

    def make(*a, **k):
        step = build(*a, **k)

        def broken(state, *args, **kw):
            before = state.x.clone()
            step(state, *args, **kw)
            keep(state, before)

        return broken

    monkeypatch.setattr(lanes, "make_micro_step", make)


@pytest.mark.parametrize("cell", ["toy.tiers.backlog", "toy.exact.backlog", "toy.tiers.p80"])
def test_sound_run_is_correct(toy_root, cell):
    v = _run(toy_root, cell)
    assert v["correct"], v
    assert len(v["checked"]) >= 3


def _unchanged(state, before):
    state.x.copy_(before)


def _half_lanes(state, before):
    half = state.x.shape[0] // 2
    state.x[half:] = before[half:]


FAULTS = {"unchanged": _unchanged, "half_lanes": _half_lanes}


def test_step_that_leaves_the_state_unchanged(toy_root, monkeypatch):
    _patch_step(monkeypatch, _unchanged)
    assert not _run(toy_root)["correct"]


def test_half_of_the_lanes_left_out(toy_root, monkeypatch):
    _patch_step(monkeypatch, _half_lanes)
    assert not _run(toy_root)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_at_the_cells_size_on_the_card(monkeypatch, fault):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault is planted at the cell's own size")
    from bench.run import fixed_caches

    fixed_caches(ROOT)
    _patch_step(monkeypatch, FAULTS[fault])
    c = spec.load_cell(CARD_CELL)
    record = serve.run_cell(c, SEED, CARD_WINDOW_S, False)
    v = check.check(c, record, Traffic(c.mix, c.config, SEED, c.model), "cuda")
    print(json.dumps(dict(cell=CARD_CELL, fault=fault, checked=v["checked"],
                          numbers={k: r["value"] for k, r in v["numbers"].items()})))
    assert v["checked"] and not v["correct"], v["numbers"]


def test_answer_altered_where_it_is_produced(toy_root, monkeypatch):
    from repro_torch.serving.engine import DiffusionEngine

    retire = DiffusionEngine._retire
    limit = spec.load_cell("toy.tiers.backlog", toy_root, toy_root / "bench").limits

    def altered(self, *a, **k):
        done = retire(self, *a, **k)
        for c in done:
            c.latent = c.latent.copy()
            c.latent.flat[0] += 3 * limit["latent_err"] * float(np.abs(c.latent).max())
        return done

    monkeypatch.setattr(DiffusionEngine, "_retire", altered)
    v = _run(toy_root)
    assert not v["correct"] and v["numbers"]["image_err"]["value"] <= v["numbers"]["image_err"]["limit"]
