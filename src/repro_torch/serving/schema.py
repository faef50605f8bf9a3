"""The v2 generate-request schema: one validated task union for the stack.

Port of ``repro/serving/schema.py``; the one difference is the kernel
backend names a payload may assert (``KERNELS_VALUES``).

Request parsing/validation for the HTTP frontend lives here, in exactly
one place.  A v2 payload carries a tagged ``task`` — ``txt2img`` | ``img2img``
| ``inpaint`` | ``variations`` — plus the task's own fields; everything is
validated into a frozen :class:`RequestSpec` before any engine object is
built, and every validation failure is a typed :class:`SchemaError`
(``code`` / ``field`` / ``detail``) the frontend maps onto structured 400
bodies instead of bare strings.

v1 compatibility: the flat pre-task payload (``prompt`` / ``seed`` /
``timesteps`` / ``quality`` / ``plan`` / ``pas``) is detected by the
*absence* of the ``task`` key and upgraded through :func:`upgrade_v1` onto
the ``txt2img`` arm — same semantics, bit-identical request synthesis —
with ``RequestSpec.v1`` set so the frontend can emit the ``Deprecation``
response header.

Task fields (see ``docs/api.md`` for the full protocol):

* every task: ``prompt`` (str), ``seed`` (int), ``timesteps`` (int, the
  *base* schedule length), ``quality`` (tier name or number in [0, 1]),
  ``plan`` (explicit PASPlan fields), ``pas`` (legacy stock-plan switch),
  ``allow_cache`` (bool), ``stream`` (bool), ``kernels`` (``"eager"`` |
  ``"cuda"``, optional) — the kernel backend is an *engine* property, so
  the field is pure assertion: a value disagreeing with the server's
  backend is a typed 400 ``forbidden`` (the frontend enforces this);
* ``img2img``: ``init`` (``{"seed": int}`` synthetic-image handle,
  required) and ``strength`` in (0, 1] (default 0.75) — the executed
  schedule is the last ``round(strength * timesteps)`` steps of the base
  schedule;
* ``inpaint``: ``init`` (required) and ``mask`` (required) — one of
  ``{"kind": "ones"}``, ``{"kind": "half", "frac": f}`` or
  ``{"kind": "explicit", "values": [...]}`` with values in [0, 1]
  (1 = generate, 0 = keep the init latent);
* ``variations``: ``variants`` (int in [2, 16]) — one prompt fanned out
  over K derived seeds, served as one co-resident lane group.
"""
from __future__ import annotations

import dataclasses
from typing import Any

#: the v2 task union
TASKS = ("txt2img", "img2img", "inpaint", "variations")

#: every key a v2 payload may carry (unknown keys are a typed 400)
V2_FIELDS = frozenset({
    "task", "prompt", "seed", "timesteps", "quality", "plan", "pas",
    "allow_cache", "stream", "init", "strength", "mask", "variants",
    "kernels",
})

#: values the optional ``kernels`` assertion field may take
KERNELS_VALUES = ("eager", "cuda")

#: explicit-plan fields (``l_*`` default to the engine's cache geometry)
PLAN_FIELDS = ("t_sketch", "t_complete", "t_sparse", "l_sketch", "l_refine")

#: error codes a structured 400 may carry
ERROR_CODES = ("invalid", "missing", "unknown", "forbidden")

#: variation fan-out bound (one group must fit a small engine)
MAX_VARIANTS = 16

MASK_KINDS = ("ones", "half", "explicit")


class SchemaError(ValueError):
    """One typed request-validation failure.

    Subclasses :class:`ValueError` so pre-schema callers that catch
    ``ValueError`` around request construction keep working unchanged.
    """

    def __init__(self, code: str, field: str, detail: str):
        assert code in ERROR_CODES, code
        super().__init__(f"{field}: {detail}")
        self.code = code
        self.field = field
        self.detail = detail

    def as_dict(self) -> dict:
        """The structured 400 body: ``{"code", "field", "detail"}``."""
        return {"code": self.code, "field": self.field, "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One validated v2 request, normalized for the request factory.

    ``timesteps`` is the *executed* step count; ``base_timesteps`` the
    untruncated schedule it was cut from (equal unless an img2img
    ``strength`` truncated it).  ``variants`` is 1 for every task except
    ``variations``.
    """

    task: str
    prompt: str
    seed: int
    timesteps: int
    base_timesteps: int
    quality: Any
    plan_spec: dict | None
    pas: bool
    allow_cache: bool
    stream: bool
    strength: float | None
    init_seed: int | None
    mask_spec: dict | None
    variants: int
    v1: bool
    #: asserted kernel backend (None = no assertion); the frontend rejects
    #: specs whose assertion disagrees with the engine's backend
    kernels: str | None = None


def is_v1(payload: Any) -> bool:
    """A flat pre-task payload (the compat-shim arm)?"""
    return isinstance(payload, dict) and "task" not in payload


def upgrade_v1(payload: dict) -> dict:
    """Map a v1 flat payload onto the v2 ``txt2img`` arm.

    v1 was never strict about unknown keys, so only the keys v2 knows are
    carried over — same leniency, same semantics.
    """
    keep = ("prompt", "seed", "timesteps", "quality", "plan", "pas",
            "allow_cache", "stream")
    out: dict = {"task": "txt2img"}
    for k in keep:
        if k in payload:
            out[k] = payload[k]
    return out


# -- field helpers -----------------------------------------------------------


def _as_int(payload: dict, field: str, default: int) -> int:
    v = payload.get(field, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)) or int(v) != v:
        raise SchemaError("invalid", field, f"must be an integer, got {v!r}")
    return int(v)


def _as_bool(payload: dict, field: str, default: bool) -> bool:
    v = payload.get(field, default)
    if not isinstance(v, bool):
        raise SchemaError("invalid", field, f"must be a boolean, got {v!r}")
    return v


def _parse_strength(payload: dict) -> float:
    v = payload.get("strength", 0.75)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise SchemaError("invalid", "strength", f"must be a number, got {v!r}")
    s = float(v)
    if not 0.0 < s <= 1.0:
        raise SchemaError("invalid", "strength", f"must be in (0, 1], got {s}")
    return s


def _parse_init(payload: dict, task: str) -> int:
    init = payload.get("init")
    if init is None:
        raise SchemaError("missing", "init", f"task {task!r} requires an init image")
    if not isinstance(init, dict) or "seed" not in init:
        raise SchemaError(
            "invalid", "init",
            'must be a synthetic-image handle {"seed": int}',
        )
    unknown = set(init) - {"seed"}
    if unknown:
        raise SchemaError("unknown", "init", f"unknown init fields: {sorted(unknown)}")
    seed = init["seed"]
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise SchemaError("invalid", "init", f"init.seed must be an integer, got {seed!r}")
    return seed


def _parse_mask(payload: dict) -> dict:
    mask = payload.get("mask")
    if mask is None:
        raise SchemaError("missing", "mask", "task 'inpaint' requires a mask")
    if not isinstance(mask, dict) or "kind" not in mask:
        raise SchemaError("invalid", "mask", 'must be an object with a "kind" field')
    kind = mask["kind"]
    if kind not in MASK_KINDS:
        raise SchemaError(
            "invalid", "mask", f"kind must be one of {list(MASK_KINDS)}, got {kind!r}"
        )
    if kind == "ones":
        extra = set(mask) - {"kind"}
    elif kind == "half":
        extra = set(mask) - {"kind", "frac"}
        frac = mask.get("frac", 0.5)
        if isinstance(frac, bool) or not isinstance(frac, (int, float)) \
                or not 0.0 <= float(frac) <= 1.0:
            raise SchemaError("invalid", "mask", f"frac must be in [0, 1], got {frac!r}")
    else:  # explicit
        extra = set(mask) - {"kind", "values"}
        values = mask.get("values")
        if not isinstance(values, list) or not values:
            raise SchemaError("invalid", "mask", "explicit mask needs a nonempty values list")
        for v in values:
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or not 0.0 <= float(v) <= 1.0:
                raise SchemaError(
                    "invalid", "mask", f"values must be numbers in [0, 1], got {v!r}"
                )
    if extra:
        raise SchemaError("unknown", "mask", f"unknown mask fields: {sorted(extra)}")
    return mask


#: fields only some tasks accept: {field: tasks allowed to carry it}
_TASK_ONLY = {
    "strength": ("img2img",),
    "init": ("img2img", "inpaint"),
    "mask": ("inpaint",),
    "variants": ("variations",),
}


def parse_request(payload: Any, *, max_steps: int) -> RequestSpec:
    """Validate one payload (v2, or v1 through the shim) into a spec.

    Raises :class:`SchemaError` on every failure; never mutates the
    payload.  ``max_steps`` is the engine bound on the *base* schedule
    (and therefore on the executed step count too).
    """
    if not isinstance(payload, dict):
        raise SchemaError("invalid", "body", "payload must be a JSON object")
    v1 = is_v1(payload)
    if v1:
        payload = upgrade_v1(payload)
    else:
        unknown = set(payload) - V2_FIELDS
        if unknown:
            raise SchemaError(
                "unknown", sorted(unknown)[0],
                f"unknown fields: {sorted(unknown)}",
            )
    task = payload.get("task")
    if task not in TASKS:
        raise SchemaError("invalid", "task", f"must be one of {list(TASKS)}, got {task!r}")
    for field, allowed in _TASK_ONLY.items():
        if field in payload and task not in allowed:
            raise SchemaError(
                "forbidden", field,
                f"field {field!r} is only valid for task(s) {list(allowed)}",
            )

    prompt = payload.get("prompt", "")
    if not isinstance(prompt, str):
        raise SchemaError("invalid", "prompt", f"must be a string, got {prompt!r}")
    seed = _as_int(payload, "seed", 0)
    base = _as_int(payload, "timesteps", max_steps)
    if not 1 <= base <= max_steps:
        raise SchemaError(
            "invalid", "timesteps", f"must be in [1, {max_steps}], got {base}"
        )
    plan_spec = payload.get("plan")
    if plan_spec is not None and not isinstance(plan_spec, dict):
        raise SchemaError("invalid", "plan", "must be a JSON object of PASPlan fields")
    pas = _as_bool(payload, "pas", False)
    allow_cache = _as_bool(payload, "allow_cache", True)
    stream = _as_bool(payload, "stream", True)
    kernels = payload.get("kernels")
    if kernels is not None and kernels not in KERNELS_VALUES:
        raise SchemaError(
            "invalid", "kernels",
            f"must be one of {list(KERNELS_VALUES)}, got {kernels!r}",
        )

    strength: float | None = None
    init_seed: int | None = None
    mask_spec: dict | None = None
    variants = 1
    timesteps = base
    if task == "img2img":
        strength = _parse_strength(payload)
        init_seed = _parse_init(payload, task)
        timesteps = max(1, round(strength * base))
    elif task == "inpaint":
        init_seed = _parse_init(payload, task)
        mask_spec = _parse_mask(payload)
    elif task == "variations":
        variants = _as_int(payload, "variants", 0)
        if not 2 <= variants <= MAX_VARIANTS:
            raise SchemaError(
                "invalid", "variants",
                f"must be in [2, {MAX_VARIANTS}], got {variants}",
            )

    return RequestSpec(
        task=task,
        prompt=prompt,
        seed=seed,
        timesteps=timesteps,
        base_timesteps=base,
        quality=payload.get("quality"),
        plan_spec=plan_spec,
        pas=pas,
        allow_cache=allow_cache,
        stream=stream,
        strength=strength,
        init_seed=init_seed,
        mask_spec=mask_spec,
        variants=variants,
        v1=v1,
        kernels=kernels,
    )
