"""The port's v2 request schema and payload generator against the JAX package's.

``repro_torch.serving.schema`` is the port's own copy of
``repro.serving.schema`` (numpy/stdlib only on both sides): every payload
case of ``tests/test_serving_schema.py`` goes through both
``parse_request`` s and yields equal specs field by field, or the same
typed ``SchemaError`` ``(code, field)``.  The one designed difference is
the kernel backend a payload may assert: ``eager`` / ``cuda`` in the port,
``xla`` / ``pallas`` in the reference.
"""
import dataclasses

import pytest

from repro.serving import client as JC
from repro.serving import schema as JS
from repro_torch.serving import client as TC
from repro_torch.serving import schema as TS

MAX_STEPS = 8

#: the payload cases of tests/test_serving_schema.py, in its order
CASES = [
    {"task": "txt2img"},
    {"task": "txt2img", "prompt": "p", "timesteps": 6},
    {"task": "img2img", "prompt": "p", "timesteps": 6, "init": {"seed": 3}, "strength": 0.5},
    {"task": "inpaint", "prompt": "p", "timesteps": 6, "init": {"seed": 3},
     "mask": {"kind": "ones"}},
    {"task": "variations", "prompt": "p", "timesteps": 6, "variants": 3},
    {"task": "upscale"},
    {"task": "txt2img", "stregnth": 0.5},
    {"task": "txt2img", "strength": 0.5},
    {"task": "img2img", "init": {"seed": 1}, "variants": 3},
    {"task": "variations", "variants": 3, "mask": {"kind": "ones"}},
    *[{"task": "txt2img", field: bad} for field, bad in [
        ("seed", "7"), ("seed", 1.5), ("seed", True),
        ("timesteps", 0), ("timesteps", MAX_STEPS + 1),
        ("prompt", 3), ("pas", "yes"), ("stream", 1), ("allow_cache", "no"),
    ]],
    {"task": "nope"},
    *[{"task": "img2img", "timesteps": base, "init": {"seed": 1}, "strength": s}
      for s, base in [(0.4, 5), (0.75, 8), (1.0, 6), (0.01, 6)]],
    {"task": "img2img", "timesteps": 8, "init": {"seed": 1}},
    *[{"task": "img2img", "init": {"seed": 1}, "strength": bad}
      for bad in (0.0, -0.5, 1.5, "high", True)],
    {"task": "img2img"},
    {"task": "img2img", "init": {"path": "x.png"}},
    {"task": "img2img", "init": {"seed": 1, "scale": 2}},
    *[{"task": "inpaint", "init": {"seed": 1}, "mask": m} for m in (
        {"kind": "ones"}, {"kind": "half", "frac": 0.25},
        {"kind": "explicit", "values": [0.0, 1.0, 0.5]},
    )],
    {"task": "inpaint", "init": {"seed": 1}},
    *[{"task": "inpaint", "init": {"seed": 1}, "mask": m} for m in (
        {"kind": "checker"}, {"kind": "half", "frac": 2.0}, {"kind": "half", "rows": 3},
        {"kind": "explicit", "values": []}, {"kind": "explicit", "values": [0.5, 1.5]},
        {"kind": "ones", "frac": 0.5},
    )],
    *[{"task": "variations", "variants": k} for k in (2, 16, 0, 1, 17)],
    {"task": "variations"},
    {"prompt": "p", "seed": 5, "timesteps": 6, "pas": True, "junk": 1},
    {"prompt": "p", "seed": 5, "timesteps": 6, "pas": True, "junk": 1, "task": "txt2img"},
    {"prompt": "x", "seed": 9, "timesteps": 4, "quality": "high"},
    {"prompt": "x", "seed": 9, "timesteps": 4, "quality": "high", "task": "txt2img"},
    [1, 2],
]


def _both(payload):
    """(outcome of repro's parse, outcome of the port's): a spec as a dict,
    or the error's (code, field)."""
    out = []
    for S in (JS, TS):
        try:
            out.append(dataclasses.asdict(S.parse_request(payload, max_steps=MAX_STEPS)))
        except S.SchemaError as e:
            out.append((e.code, e.field))
    return out


@pytest.mark.parametrize("payload", CASES, ids=range(len(CASES)))
def test_every_schema_case_parses_alike_in_both_packages(payload):
    ref, port = _both(payload)
    assert port == ref


@pytest.mark.parametrize("v1,task", [(False, "mix"), (True, "txt2img")])
def test_generated_payloads_are_equal_and_parse_alike(v1, task):
    for seed in range(3):
        kw = dict(quality="mix", task=task, v1=v1)
        ref = JC.make_payloads(16, 3, MAX_STEPS, "mixed", seed, **kw)
        port = TC.make_payloads(16, 3, MAX_STEPS, "mixed", seed, **kw)
        assert port == ref
        for payload in port:
            a, b = _both(payload)
            assert isinstance(a, dict) and b == a
            assert b["v1"] == v1


def test_v1_payloads_cannot_carry_another_task_in_either_package():
    for C in (JC, TC):
        with pytest.raises(ValueError):
            C.make_payloads(4, 3, 6, "mixed", 0, quality="mix", task="mix", v1=True)


@pytest.mark.parametrize("kernels", ["eager", "cuda"])
def test_port_backend_names_parse(kernels):
    spec = TS.parse_request({"task": "txt2img", "kernels": kernels}, max_steps=MAX_STEPS)
    assert spec.kernels == kernels
    with pytest.raises(JS.SchemaError) as ei:  # the reference's names are xla | pallas
        JS.parse_request({"task": "txt2img", "kernels": kernels}, max_steps=MAX_STEPS)
    assert (ei.value.code, ei.value.field) == ("invalid", "kernels")


def test_reference_backend_name_is_refused_by_the_port():
    with pytest.raises(TS.SchemaError) as ei:
        TS.parse_request({"task": "txt2img", "kernels": "xla"}, max_steps=MAX_STEPS)
    assert (ei.value.code, ei.value.field) == ("invalid", "kernels")
    assert ei.value.as_dict()["code"] == "invalid"
    assert TS.KERNELS_VALUES == ("eager", "cuda")
