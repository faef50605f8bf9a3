"""Whether the window's outputs are correct: a sample of the requests that
finished in the window, each run straight through the plain reference
(the configuration's model module, ``bench/reference/<model>.py``) from
the same noise, conditioning, tier and seeded weights, compared with what
the program served.

Two numbers are compared, each against its limit in
``bench/limits/<cell>.json``:

* ``latent_err``: over the sample, the largest max |served - reference|
  of a final latent, over the reference latent's max |value|;
* ``image_err``: the same of the decoded image.

The reference runs after the program's engine is gone, in float32 with
TF32 off (``precision="fp32"``); the control computes the same in TF32
(``precision="tf32"``).
"""
from __future__ import annotations

import numpy as np

from bench.counts import in_window, is_due
from bench.reference.weights import make_weights

#: tiers by the work a request of the tier asks for, most first
BY_WORK = ("exact", "high", "balanced", "draft")
#: requests the reference runs together (a CFG batch of 8)
BATCH = 4


def finished_in_window(record: dict) -> list[int]:
    """Requests the window served: those that finished in it (a backlog),
    or those due in it that finished (open loop)."""
    out = []
    for i, log in record["requests"].items():
        if log["done"] is None or i not in record["outputs"]:
            continue
        if is_due(record, log["due"]) if record["open_loop"] else in_window(record, log["done"]):
            out.append(i)
    return sorted(out)


def sample(record: dict, k: int) -> list[int]:
    """``k`` of the window's requests drawn from the seed, with one of the
    most demanding tier served among them."""
    pool = finished_in_window(record)
    if not pool:
        return []
    rng = np.random.default_rng((int(record["seed"]) % 2**64, 4))
    tiers = {i: record["requests"][i]["tier"] for i in pool}
    top = min(tiers.values(), key=BY_WORK.index)
    first = [i for i in pool if tiers[i] == top]
    pick = [first[int(rng.integers(len(first)))]]
    rest = [i for i in pool if i != pick[0]]
    pick += [rest[j] for j in rng.permutation(len(rest))[: k - 1]]
    return sorted(pick)


def reference_outputs(cell, record: dict, rids: list[int], device, precision: str,
                      traffic) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """The reference's (latent, image) of each request in ``rids``."""
    import torch

    cfg, e, model = cell.config, cell.config["engine"], cell.model
    u = cfg["unet"]
    unet_w, vae_w = make_weights(u, record["seed"], device, model)
    lhw = (u["latent_size"],) * 2
    out = {}
    by_tier: dict[str, list[int]] = {}
    for i in rids:
        by_tier.setdefault(record["requests"][i]["tier"], []).append(i)
    stack = lambda arrays: torch.from_numpy(np.stack(arrays)).to(device)  # noqa: E731
    with torch.no_grad(), model.precision(precision, torch.device(device)):
        for tier, ids in sorted(by_tier.items()):
            for j in range(0, len(ids), BATCH):
                part = ids[j:j + BATCH]
                reqs = [traffic.request(i) for i in part]
                noise = stack([r.noise for r in reqs])
                cond = {k: stack([r.cond[k] for r in reqs]) for k in reqs[0].cond}
                lat = model.sample(u, dict(cfg["sampler"]), unet_w, noise, cond, tier,
                                   l_sketch=e["l_sketch"], l_refine=e["l_refine"])
                img = model.vae_decode(vae_w, lat, lhw)
                for i, a, b in zip(part, lat.cpu().numpy(), img.cpu().numpy()):
                    out[i] = (a, b)
    del unet_w, vae_w
    return out


def rel_err(served: np.ndarray, ref: np.ndarray) -> float:
    if served is None or served.shape != ref.shape or not np.all(np.isfinite(served)):
        return float("inf")
    return float(np.max(np.abs(served.astype(np.float64) - ref)) / max(np.max(np.abs(ref)), 1e-30))


def compare(record: dict, refs: dict[int, tuple[np.ndarray, np.ndarray]]) -> dict[str, float]:
    lat = [rel_err(record["outputs"][i][0], refs[i][0]) for i in refs]
    img = [rel_err(record["outputs"][i][1], refs[i][1]) for i in refs]
    return {"latent_err": max(lat, default=float("inf")),
            "image_err": max(img, default=float("inf"))}


def check(cell, record: dict, traffic, device, refs: dict | None = None) -> dict:
    """The compared numbers beside their limits, and ``correct``.  ``refs``:
    the reference's outputs of this record's sample where already computed
    (the control's check reuses the program's)."""
    rids = sample(record, int(cell.mix["check"]["sample"]))
    if refs is None:
        refs = reference_outputs(cell, record, rids, device, "fp32", traffic) if rids else {}
    numbers = compare(record, {i: refs[i] for i in rids})
    limits = cell.limits
    rows = {k: {"value": v, "limit": float(limits[k])} for k, v in numbers.items()}
    correct = bool(rids) and all(r["value"] <= r["limit"] for r in rows.values())
    return dict(correct=correct, checked=rids, numbers=rows, refs=refs)
