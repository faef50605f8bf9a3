"""The one traffic generator: requests of a mix, from the mix's parameters
and the seed.

A mix file (``bench/mixes/<name>.json``) sets:

* ``task`` ("txt2img") and ``steps`` (sampling steps a request asks for);
* ``tiers``: quality tier -> weight.  Tiers come in blocks that hold each
  tier as often as its weight, each block in an order drawn from
  ``order_seed``;
* ``arrivals``: ``{"kind": "backlog", "queued": Q, "stagger_steps": S}``
  keeps Q requests queued beyond the lanes (a new one each time one
  finishes); the first lanes fill one every S steps of the first request,
  so lanes start out of step, as in a service that has run for a while.
  ``{"kind": "poisson", "rate_per_s": R}`` sends requests at due times
  whose gaps are exponential of rate R, drawn from ``order_seed``: one
  draw of a Poisson schedule, not stratified, the same for every seed;
* ``window``: when the measured window opens (``{"after_done": n}``: at
  the n-th completion; ``{"after_s": s}``: s seconds after traffic starts)
  and, for open-loop traffic, ``drain_s``: how long after the window closes
  a request due in it may take to finish before it counts as failed;
* ``check``: ``{"sample": k}`` requests checked against the reference;
* ``order_seed`` (required): the order of the tier blocks and the arrival
  schedule are drawn from it and not from the run's seed, so every seed
  serves the same sequence of plans and arrivals.  The branch vote's
  packing, and so the work, depends on the order of the plans: a cell
  measures one fixed order.

Each request's conditioning and initial noise [L, C] are drawn from
(seed, index) alone, the conditioning first: the configuration's model
module (``bench/reference/<model>.py``) draws its named arrays with
``conditioning(cfg, rng)``.  For the model ``sd`` that is the prompt
embedding ``ctx`` [ctx_len, ctx_dim], normal with scale 0.2.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TIERS = ("draft", "balanced", "high", "exact")


def _seed(seed: int) -> int:
    return int(seed) % 2**64


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    tier: str
    steps: int
    cond: dict[str, np.ndarray]  # the program's GenRequest takes each by its name
    noise: np.ndarray


class Traffic:
    """Requests of ``mix`` for configuration ``cfg`` from ``seed``;
    ``model``: the configuration's model module, which draws the
    conditioning."""

    def __init__(self, mix: dict, cfg: dict, seed: int, model):
        if mix["task"] != "txt2img":
            raise ValueError(f"unsupported task {mix['task']!r}")
        unknown = set(mix["tiers"]) - set(TIERS)
        if unknown:
            raise ValueError(f"unknown tiers {sorted(unknown)}")
        if "order_seed" not in mix:
            raise ValueError("a mix needs order_seed: the order of its plans sets the work")
        self.mix, self.cfg, self.seed, self.model = mix, cfg, _seed(seed), model
        self.order = _seed(mix["order_seed"])
        self.steps = int(mix["steps"])
        self.arrivals = mix["arrivals"]
        if self.arrivals["kind"] not in ("backlog", "poisson"):
            raise ValueError(f"unknown arrivals {self.arrivals['kind']!r}")
        self._tiers: list[str] = []
        self._due: list[float] = []
        self._gaps = np.random.default_rng((self.order, 3))

    @property
    def open_loop(self) -> bool:
        return self.arrivals["kind"] == "poisson"

    def tier(self, i: int) -> str:
        block = [t for t, k in self.mix["tiers"].items() for _ in range(int(k))]
        while len(self._tiers) <= i:
            rng = np.random.default_rng((self.order, 1, len(self._tiers) // len(block)))
            self._tiers += [block[j] for j in rng.permutation(len(block))]
        return self._tiers[i]

    def request(self, i: int) -> Request:
        cfg = self.cfg["unet"]
        rng = np.random.default_rng((self.seed, 2, i))
        cond = self.model.conditioning(cfg, rng)
        noise = rng.normal(size=(cfg["latent_size"] ** 2, cfg["in_channels"])).astype(np.float32)
        return Request(i, self.tier(i), self.steps, cond, noise)

    def due_s(self, i: int) -> float:
        """Open loop: request i's due time, seconds after traffic starts."""
        if not self.open_loop:
            raise ValueError("a backlog has no due times")
        scale = 1.0 / float(self.arrivals["rate_per_s"])
        while len(self._due) <= i:
            t = self._due[-1] if self._due else 0.0
            self._due += (t + np.cumsum(self._gaps.exponential(scale, size=64))).tolist()
        return self._due[i]
