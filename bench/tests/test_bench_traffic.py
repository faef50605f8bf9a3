"""The traffic generator: the same seed gives the same requests and
arrivals; every seed offers the same plans in the same order and the same
arrival schedule, one exponential draw from the mix's ``order_seed``."""
from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

from bench import spec
from bench.tests.conftest import ROOT
from bench.traffic import Traffic

CFG = json.loads((ROOT / "bench" / "configs" / "sd_v14.json").read_text())
SD = spec.load_model("sd")
MIX = {n: json.loads((ROOT / "bench" / "mixes" / f"{n}.json").read_text())
       for n in ("tiers.backlog", "exact.backlog")}
#: the open-loop form of the tiers mix (no cell of the benchmark uses it yet)
MIX["tiers.poisson"] = dict(MIX["tiers.backlog"], arrivals={"kind": "poisson", "rate_per_s": 0.4})
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_arrivals_and_requests_repeat_per_seed(seed):
    a, b = (Traffic(MIX["tiers.poisson"], CFG, seed, SD) for _ in range(2))
    assert [a.due_s(i) for i in range(40)] == [b.due_s(i) for i in range(40)]
    assert [a.tier(i) for i in range(40)] == [b.tier(i) for i in range(40)]
    ra, rb = a.request(5), b.request(5)
    assert set(ra.cond) == {"ctx"} and np.array_equal(ra.cond["ctx"], rb.cond["ctx"])
    assert np.array_equal(ra.noise, rb.noise)
    assert ra.cond["ctx"].shape == (77, 768) and ra.noise.shape == (4096, 4)


@pytest.mark.parametrize("mix", ["tiers.backlog", "tiers.poisson"])
def test_every_seed_offers_the_same_plans_and_schedule(mix):
    """Every seed: the same tiers in the same order, each block of 4 holding
    the mix's weights, and (open loop) the same due times."""
    orders, schedules = set(), set()
    for seed in SEEDS:
        t = Traffic(MIX[mix], CFG, seed, SD)
        tiers = [t.tier(i) for i in range(40)]
        assert Counter(tiers) == Counter(draft=10, balanced=20, high=10)
        for j in range(0, 40, 4):
            assert Counter(tiers[j:j + 4]) == Counter(draft=1, balanced=2, high=1)
        orders.add(tuple(tiers))
        if t.open_loop:
            schedules.add(tuple(t.due_s(i) for i in range(100)))
    assert len(orders) == 1 and len(schedules) == (1 if mix == "tiers.poisson" else 0)


def test_poisson_gaps_are_exponential_draws():
    """The gaps are drawn, not quantiles: their mean is 1 / rate, their
    spread that of an exponential, and blocks of 16 span different times."""
    t = Traffic(MIX["tiers.poisson"], CFG, 5, SD)
    due = np.array([t.due_s(i) for i in range(4000)])
    gaps = np.diff(np.concatenate([[0.0], due]))
    rate = MIX["tiers.poisson"]["arrivals"]["rate_per_s"]
    assert abs(gaps.mean() * rate - 1) < 0.05 and abs(gaps.std() * rate - 1) < 0.07
    spans = np.diff(due[15::16])
    assert spans.std() > 0.1 * spans.mean()


def test_a_mix_without_order_seed_is_refused():
    mix = {k: v for k, v in MIX["tiers.backlog"].items() if k != "order_seed"}
    with pytest.raises(ValueError, match="order_seed"):
        Traffic(mix, CFG, 1, SD)


def test_backlog_has_no_due_times_and_exact_is_all_exact():
    t = Traffic(MIX["exact.backlog"], CFG, 3, SD)
    assert not t.open_loop and {t.tier(i) for i in range(20)} == {"exact"}
    with pytest.raises(ValueError):
        t.due_s(0)
