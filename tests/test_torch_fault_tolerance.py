"""The port's training-loop half of ``runtime/fault_tolerance.py`` against
``repro``'s: ``ElasticPlan`` equal over a grid of meshes, failures and
batches (the same plan or the same refusal), and ``FaultTolerantLoop``'s
resume and preemption cases of ``tests/test_fault_tolerance.py`` on the
port's checkpoint manager, with a tensor in the state.  The module imports
without torch (the router's process loads it)."""
import itertools
import os
import signal
import subprocess
import sys

import pytest
import torch

from repro.runtime import fault_tolerance as JFT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime import fault_tolerance as TFT

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _plan(mod, *args):
    try:
        return mod.ElasticPlan.plan(*args)
    except RuntimeError as e:
        return str(e)


@pytest.mark.parametrize("model", [1, 4, 8, 16])
def test_elastic_plan_equals_reference(model):
    for data, failed, batch in itertools.product(
            [1, 2, 3, 7, 16, 32], [0, 1, 3, 4, 17, 40, 64], [7, 64, 128, 256, 500]):
        ref, got = _plan(JFT, data, model, failed, batch), _plan(TFT, data, model, failed, batch)
        if isinstance(ref, str):
            assert got == ref
        else:
            assert type(got) is TFT.ElasticPlan and got.__dict__ == ref.__dict__


def test_loop_resumes_from_checkpoint(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=3)
    calls = []

    def step_fn(state, step):
        calls.append(step)
        if step == 7:
            raise KeyboardInterrupt  # simulated node failure
        return {"x": state["x"] + 1}

    loop = TFT.FaultTolerantLoop(ckpt=cm, save_every=3, max_steps=10)
    with pytest.raises(KeyboardInterrupt):
        loop.run({"x": torch.zeros(2)}, step_fn, log=lambda _: None)
    assert cm.list_steps()[-1] == 6  # last committed step

    calls.clear()
    logs = []

    def step_ok(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}

    loop2 = TFT.FaultTolerantLoop(ckpt=cm, save_every=3, max_steps=10)
    out = loop2.run({"x": torch.zeros(2)}, step_ok, log=logs.append)
    assert calls == [6, 7, 8, 9]
    assert logs[0] == "[ft] resumed from step 6"
    assert isinstance(out["x"], torch.Tensor) and float(out["x"][0]) == 6 + 4
    assert cm.list_steps() == [3, 6, 9]


def test_loop_preemption_checkpoints(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    guard = TFT.PreemptionGuard(install=False)

    def step_fn(state, step):
        if step == 4:
            guard.requested = True  # SIGTERM arrives mid-step
        return state

    loop = TFT.FaultTolerantLoop(ckpt=cm, save_every=100, max_steps=10)
    loop.run({"x": torch.zeros(1)}, step_fn, guard=guard, log=lambda _: None)
    assert cm.list_steps() == [5], "preemption must publish step+1 immediately"


def test_preemption_guard_flips_on_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    try:
        guard = TFT.PreemptionGuard()
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_module_imports_without_torch():
    code = ("import sys\nimport repro_torch.runtime.fault_tolerance as m\n"
            "assert m.FaultTolerantLoop and m.ElasticPlan and m.PreemptionGuard\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    out = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": SRC, "PATH": ""},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
