"""The port's feature cache, spill ring and schedulers against the JAX package's.

The same sequence of reserve / probe / hit / insert / eviction / promote
runs on ``repro.serving.cache.FeatureCache`` and on the port's; the host
metadata (keys, validity, LRU clock, counters, stats) must be
identical after every operation and the slot features bit-identical, since
the device half is pure copies on both sides.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_unet_config
from repro.core import sampler as JSM
from repro.models import unet as JU
from repro.serving import cache as JC
from repro.serving import scheduler as JS
from repro_torch.core import sampler as TSM
from repro_torch.serving import cache as TC
from repro_torch.serving import scheduler as TS

TOY = get_unet_config("sd_toy")
N_UP = JU.n_up_steps(TOY)
E_SK, E_RF = N_UP - 3, N_UP - 2
META = ("bucket", "rid", "sig", "valid", "last_use", "offset", "gen")


def _pair(**kw):
    kw = dict(dict(n_slots=3, threshold=0.2, t_bucket=100, mode="cross"), **kw)
    return (JC.FeatureCache(TOY, E_SK, E_RF, **kw),
            TC.FeatureCache(TOY, E_SK, E_RF, device="cpu", **kw))


def _lane_feats(seed, n_lanes=2):
    rng = np.random.default_rng(seed)
    sk = rng.normal(size=TSM.feat_shape(TOY, E_SK, 2 * n_lanes)).astype(np.float32)
    rf = rng.normal(size=TSM.feat_shape(TOY, E_RF, 2 * n_lanes)).astype(np.float32)
    return sk, rf


def _assert_same(j, t):
    for f in META:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.counters() == j.counters()
    assert t.stats() == j.stats()
    assert t.n_warm == j.n_warm
    # the published keys (GET /stats and GET /cache/keys)
    assert t.version == j.version
    assert t.slots_summary() == j.slots_summary()
    for since in (0, max(0, j.version - 1), j.version):
        assert t.keys_delta(since) == j.keys_delta(since)
    np.testing.assert_array_equal(t.state.f_sk.numpy(), np.asarray(j.state.f_sk))
    np.testing.assert_array_equal(t.state.f_rf.numpy(), np.asarray(j.state.f_rf))


def _insert(j, t, feats, keys, exclude=()):
    """Reserve one slot per (lane, t, sig, rid, offset) key on both caches and
    fill them with one padded batched insert, as the engine does."""
    sk, rf = feats
    n = sk.shape[0] // 2
    lanes = np.zeros((n,), np.int32)
    slots_j = np.full((n,), j.n_slots, np.int32)
    slots_t = np.full((n,), t.n_slots, np.int64)
    taken_j, taken_t = set(exclude), set(exclude)
    for k, (lane, ts, sig, rid, off) in enumerate(keys):
        sj = j.reserve(ts, sig, rid, exclude=taken_j, offset=off)
        st = t.reserve(ts, sig, rid, exclude=taken_t, offset=off)
        assert sj == st
        if sj is None:
            continue
        taken_j.add(sj)
        taken_t.add(st)
        lanes[k], slots_j[k], slots_t[k] = lane, sj, st
    j.insert_many(jnp.asarray(sk), jnp.asarray(rf), lanes, slots_j)
    t.insert_many(torch.from_numpy(sk), torch.from_numpy(rf), lanes, slots_t)


def _insert_one(cache, feats, **key):
    """Reserve a slot and fill it from lane 0, as the engine does."""
    slot = cache.reserve(**key)
    cache.insert_many(torch.from_numpy(feats[0]), torch.from_numpy(feats[1]),
                  np.array([0]), np.array([slot]))


def _sig(seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=(TOY.ctx_dim,)).astype(np.float32) * scale


@pytest.mark.parametrize("mode", ["cross", "intra"])
@pytest.mark.parametrize("spill_mb", [0.0, 4.0])
def test_cache_sequence_matches_jax(mode, spill_mb):
    j, t = _pair(mode=mode, spill_mb=spill_mb)
    _assert_same(j, t)
    a, b = _sig(1), _sig(2)
    near = a + 0.05 * _sig(3) * np.linalg.norm(a) / np.linalg.norm(_sig(3))
    _insert(j, t, _lane_feats(0), [(0, 850, a, 1, 0), (1, 850, b, 2, 0)])
    _assert_same(j, t)
    for args in ((850, near, 9, 0.2, 0), (850, near, 1, 0.2, 0), (850, a, 1, 0.2, 0),
                 (850, near, 9, 0.0, 0), (850, near, 9, 0.2, 3), (750, near, 9, 0.2, 0),
                 (850, b, 2, 1e-3, 0), (850, b, 7, None, 0)):
        assert t.probe_distance(*args) == j.probe_distance(*args)
        assert t.probe(*args) == j.probe(*args)
    hit = j.probe(850, near, 9, 0.2)
    if hit is not None:
        j.note_hit(hit)
        t.note_hit(hit)
    j.note_miss()
    t.note_miss()
    # JAX's one-call lookup is the port's probe, then hit or miss
    slot = t.probe(850, a, 1, 0.3)
    t.note_hit(slot) if slot is not None else t.note_miss()
    assert slot == j.lookup(850, a, 1, 0.3)
    _assert_same(j, t)
    # a refresh in place, then evictions (3 slots, 5 keys), one exclusion
    _insert(j, t, _lane_feats(1), [(1, 850, a, 1, 0), (0, 250, b, 2, 0)])
    _insert(j, t, _lane_feats(2), [(0, 450, _sig(4), 3, 0), (1, 650, _sig(5), 4, 2)],
            exclude={0})
    _assert_same(j, t)
    assert j.evictions > 0
    # promotion back from the spill (None on both without one)
    for args in ((850, near, 9, 0.2, 0), (250, b, 9, 0.5, 0), (850, a, 1, 0.2, 0),
                 (850, near, 9, 0.0, 0)):
        assert t.promote(*args) == j.promote(*args)
        _assert_same(j, t)
    j.reset()
    t.reset()
    _assert_same(j, t)


def test_published_keys_are_capped_as_in_jax():
    """Past MAX_SUMMARY_SLOTS warm slots the key table keeps the most
    recently used (summary) or the newest generations (delta)."""
    j, t = (R(70, TOY.ctx_dim, t_bucket=100) for R in (JC.SlotRing, TC.SlotRing))
    for i in range(80):  # fills the ring, then evicts and refreshes
        for ring in (j, t):
            ring.reserve(100 * (i % 9), _sig(i % 75), i % 75, offset=i % 2)
    t.note_hit(3)
    j.note_hit(3)
    assert TC.MAX_SUMMARY_SLOTS == JC.MAX_SUMMARY_SLOTS == 64
    assert len(t.slot_summary()) == 64 and t.slot_summary() == j.slot_summary()
    for since in (0, 20, 79, 80):
        assert t.key_delta(since) == j.key_delta(since)
    assert t.version == j.version == 80 and t.key_delta(80) == []


def test_plan_warmth_matches_jax():
    j, t = _pair(n_slots=4, t_bucket=1000)
    a = _sig(1)
    _insert(j, t, _lane_feats(0), [(0, 900, a, 1, 0), (1, 100, _sig(2), 2, 0)])

    @dataclasses.dataclass
    class Req:  # duck-typed on the engine's request
        rid: int
        _lane_plan: object
        _sig: np.ndarray
        sched_offset: int = 0

    class LP:
        branches = np.array([0, 0, 1, 0, 2, 0], np.int32)
        ts = np.array([900, 700, 500, 300, 100, 0], np.int32)
        n_steps = 6
        thr = np.array([0.3, 0.0, 0.3, 0.3, 0.3, 0.05], np.float32)

    for req in (Req(5, LP, a), Req(1, LP, a), Req(5, LP, a * 1.2), Req(5, LP, a, 2), object()):
        assert t.plan_warmth(req) == j.plan_warmth(req)


def test_select_entry_features_passthrough_and_pick():
    rng = np.random.default_rng(0)
    own = rng.normal(size=(6, 16, 8)).astype(np.float32)
    slots = rng.normal(size=(4, 2, 16, 8)).astype(np.float32)
    for src, use in (([-1, -1, -1], None), ([2, -1, 0], None), ([2, 3, 0], [True, False, True]),
                     ([1, 1, -1], [False, False, False])):
        ref = JC.select_entry_features(
            jnp.asarray(own), jnp.asarray(slots), jnp.asarray(src, jnp.int32),
            None if use is None else jnp.asarray(use),
        )
        got = TC.select_entry_features(
            torch.from_numpy(own), torch.from_numpy(slots), torch.tensor(src),
            None if use is None else torch.tensor(use),
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = TC.select_entry_features(torch.from_numpy(own), torch.from_numpy(slots),
                                   torch.tensor([-1, -1, -1]))
    assert torch.equal(got, torch.from_numpy(own))  # exact passthrough
    got = TC.select_entry_features(torch.from_numpy(own), torch.from_numpy(slots),
                                   torch.tensor([3, -1, -1]))
    np.testing.assert_array_equal(got[0].numpy(), slots[3, 0])  # cond row of lane 0
    np.testing.assert_array_equal(got[3].numpy(), slots[3, 1])  # uncond row of lane 0


def test_padded_insert_touches_only_its_slots():
    _, t = _pair(n_slots=4)
    for f in (t.state.f_sk, t.state.f_rf):
        f.copy_(torch.arange(f.numel(), dtype=torch.float32).reshape(f.shape))
    before = (t.state.f_sk.clone(), t.state.f_rf.clone())
    sk, rf = _lane_feats(7, n_lanes=3)
    # lane 2 -> slot 1; the two padding entries (slot 4 = n_slots) are dropped
    t.insert_many(torch.from_numpy(sk), torch.from_numpy(rf),
                  np.array([2, 0, 1]), np.array([1, 4, 4]))
    for got, old, lane_feats in ((t.state.f_sk, before[0], sk), (t.state.f_rf, before[1], rf)):
        for s in (0, 2, 3):
            assert torch.equal(got[s], old[s])
        np.testing.assert_array_equal(got[1, 0].numpy(), lane_feats[2])
        np.testing.assert_array_equal(got[1, 1].numpy(), lane_feats[3 + 2])
    t.insert_many(torch.from_numpy(sk), torch.from_numpy(rf),
                  np.array([0, 1, 2]), np.array([4, 4, 4]))  # all padding: a no-op
    assert torch.equal(t.state.f_sk[0], before[0][0])


def test_spill_round_trip_is_bitwise_lossless():
    """Evict a capture to the host ring and promote it back: the slot's
    features are bit-identical to the original capture (awkward float32
    values included)."""
    _, t = _pair(n_slots=1, t_bucket=1, spill_mb=4)
    sk, rf = _lane_feats(3, n_lanes=1)
    sk[0, 0, :4] = [np.float32(1e-38), np.float32(-0.0), np.float32(3.4e38), np.nextafter(1, 2)]
    sig = _sig(1)
    _insert_one(t, (sk, rf), t=1, sig=sig, rid=1)
    want = (t.state.f_sk[0].clone(), t.state.f_rf[0].clone())
    other = _lane_feats(4, n_lanes=1)
    _insert_one(t, other, t=2, sig=10 * sig, rid=2)
    assert t.spill.demotions == 1 and t.probe(1, sig, rid=9) is None
    slot = t.promote(t=1, sig=sig, rid=9, threshold=0.5)
    assert slot is not None and t.spill.promotions == 1
    assert t.probe(1, sig, rid=9) == slot and t.probe(1, sig, rid=1) is None  # owner kept
    assert torch.equal(t.state.f_sk[slot], want[0]) and torch.equal(t.state.f_rf[slot], want[1])
    # the spilled copy did not alias the device slot that was overwritten
    entry = next(iter(t.spill._entries.values()))
    np.testing.assert_array_equal(entry.f_sk, want[0].numpy())


def test_spill_ring_policy_matches_jax():
    rng = np.random.default_rng(0)
    shape = (2, 4, 3)
    js, ts = JC.SpillRing(1000, mode="cross"), TC.SpillRing(1000, mode="cross")
    for i in range(8):  # byte cap 1000 holds 5 entries of 192 bytes
        f = rng.normal(size=shape).astype(np.float32)
        args = (i % 3, i % 2, i, _sig(i), f, f)
        assert ts.put(*args) == js.put(*args)
        assert ts.stats() == js.stats()
    for args in ((1, _sig(4), 9, 0.5, 0), (2, _sig(5), 5, 0.5, 1), (0, _sig(6), 1, 0.0, 0)):
        je, te = js.probe(*args), ts.probe(*args)
        assert (je is None) == (te is None)
        if je is not None:
            assert (te.bucket, te.offset, te.rid) == (je.bucket, je.offset, je.rid)
    assert list(ts._entries) == list(js._entries)
    big = np.zeros((100, 100), np.float32)
    assert ts.put(0, 0, 0, _sig(0), big, big) is js.put(0, 0, 0, _sig(0), big, big) is False
    with pytest.raises(ValueError):
        TC.SpillRing(-1)


def test_signature_helpers_and_bad_configs_match_jax():
    ctx = np.random.default_rng(0).normal(size=(7, TOY.ctx_dim)).astype(np.float32)
    np.testing.assert_array_equal(TC.prompt_signature(ctx), JC.prompt_signature(ctx))
    a, b = _sig(1), _sig(2)
    assert TC.signature_distance(a, b) == JC.signature_distance(a, b)
    for kw in (dict(mode="global"), dict(n_slots=0), dict(threshold=-1.0), dict(t_bucket=0)):
        with pytest.raises(ValueError):
            JC.FeatureCache(TOY, E_SK, E_RF, **kw)
        with pytest.raises(ValueError):
            TC.FeatureCache(TOY, E_SK, E_RF, **kw)


class _Req:
    def __init__(self, rid, branches):
        self.rid = rid
        self._branches = np.asarray(branches)

    def branch_vector(self):
        return self._branches


def _queue():
    return [_Req(i, b) for i, b in enumerate(
        ([0, 1, 2, 2], [0, 0, 0, 0], [0, 1, 1, 2], [0, 2, 2, 2], [1, 1], [0, 0, 1, 2]))]


@pytest.mark.parametrize("warm", [False, True])
def test_cache_aware_scheduler_matches_jax(warm):
    """Admission order of the port's CacheAwareScheduler equals JAX's, cold
    (plan-aware) and with a stand-in cache that scores warmth by rid."""
    class Warmth:
        n_warm = 1 if warm else 0

        def plan_warmth(self, req, shard=None):
            return (req.rid % 3) / 3 if warm else 0.0

    orders = []
    for pkg in (JS, TS):
        s = pkg.CacheAwareScheduler(window=3)
        s.attach_cache(Warmth())
        for r in _queue():
            s.add(r)
        assert s.remove(3) and not s.remove(99)
        assert len(s) == 5
        flight = [np.array([0, 1, 2]), np.array([0, 0])]
        orders.append([s.next_request(flight).rid for _ in range(5)])
        assert s.next_request(flight) is None
    assert orders[0] == orders[1]


def test_plan_aware_scheduler_matches_jax():
    orders = []
    for pkg in (JS, TS):
        s = pkg.PlanAwareScheduler(window=4)
        for r in _queue():
            s.add(r)
        orders.append([s.next_request([np.array([0, 0, 1])]).rid for _ in range(6)])
    assert orders[0] == orders[1]


def test_feat_shapes_match_jax():
    for e in (E_SK, E_RF):
        assert TSM.feat_shape(TOY, e, 4) == JSM.feat_shape(TOY, e, 4)
