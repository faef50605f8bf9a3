"""Cross-request feature cache for the continuous-batching engine, single device.

Port of the single-device half of ``repro/serving/cache.py``.  The features
the engine's FULL steps capture for its own partial steps (paper Key
Observation 1) are kept in a ring of slots that *other* lanes, or later
steps of the same request, consume, turning would-be FULL micro-steps into
SKETCH micro-steps.

* **Device**: :class:`CacheState`, float32 tensors ``[S, 2, L, C]`` on the
  engine's device, cond/uncond pairs in the engine's CFG-doubled layout.
  Insert is one indexed copy of the stacked lane pairs, lookup inside the
  micro-step a gather by a per-lane slot index.  These are plain PyTorch
  indexing, as the JAX package computes them in plain ``jnp``.
* **Host** (numpy): per-slot keys (timestep bucket, prompt signature,
  schedule offset), validity, owner rid, an LRU clock, and the host-RAM
  spill ring under the device slots.  The hit rule is a shift-score-style
  relative distance ``||sig - slot_sig|| / ||slot_sig|| < threshold``,
  strict, so ``threshold=0`` never hits and stays bit-exact with the cache
  off.

Modes are disjoint reuse scopes: ``"intra"`` restricts hits to slots the
same request inserted (DeepCache-style self reuse), ``"cross"`` to other
requests' slots.  Every key write stamps its slot with a generation, so
the HTTP layer can publish the warm keys (``slots_summary``) and their
changes since a cursor (``keys_delta``).

The sharded engine's :class:`ShardedFeatureCache` keeps one ring per lane
shard, its device slots on the shard's device, under one generation clock,
and one spill ring that every shard shares, so a capture demoted off one
shard's ring can be promoted onto another's.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.common.types import UNetConfig, added_cond_dim
from repro_torch.core import sampler as SM

#: slot cap on one ring's published key table (``slot_summary`` /
#: ``key_delta``): an over-provisioned ring must not bloat every ``/stats``
#: poll, so only the most recently used slots are reported and consumers
#: must tolerate truncation
MAX_SUMMARY_SLOTS = 64


@dataclasses.dataclass
class CacheState:
    """Device-resident feature slots.  Row 0 of the pair axis is the cond
    feature, row 1 the uncond feature (rows ``i`` / ``N + i`` of the
    engine's CFG-doubled lane caches)."""

    f_sk: torch.Tensor  # [S, 2, L_sk, C_sk] sketch-entry features
    f_rf: torch.Tensor  # [S, 2, L_rf, C_rf] refine-entry features

    @property
    def n_slots(self) -> int:
        return self.f_sk.shape[0]


def prompt_signature(ctx: np.ndarray, pooled: np.ndarray | None = None) -> np.ndarray:
    """Pooled prompt-embedding signature used as the cache key: [ctx_dim],
    then the pooled prompt vector where the request has one ([ctx_dim +
    pooled_dim], :func:`sig_dim`).  The time ids are in the key's exact
    part (``GenRequest.cache_offset``)."""
    sig = np.asarray(ctx, np.float32).mean(axis=0)
    if pooled is None:
        return sig
    return np.concatenate([sig, np.asarray(pooled, np.float32)])


def sig_dim(ucfg: UNetConfig) -> int:
    """Width of :func:`prompt_signature` for ``ucfg``'s requests."""
    return ucfg.ctx_dim + (ucfg.pooled_dim if added_cond_dim(ucfg) else 0)


def signature_distance(sig: np.ndarray, ref: np.ndarray) -> float:
    """Shift-score-style relative distance (paper Eq. 1 on pooled prompts)."""
    ref = np.asarray(ref, np.float32)
    return float(np.linalg.norm(np.asarray(sig, np.float32) - ref) / (np.linalg.norm(ref) + 1e-12))


def _insert_slots(
    cache: CacheState,
    f_sk: torch.Tensor,  # [2N, L_sk, C_sk] lane sketch cache
    f_rf: torch.Tensor,  # [2N, L_rf, C_rf] lane refine cache
    lanes: np.ndarray,  # [K] source lanes
    slots: np.ndarray,  # [K] target slots; >= n_slots marks padding
) -> None:
    """Batched slot fill, in place: one indexed copy for all of a
    micro-step's FULL captures.  Padding entries are dropped here on the
    host (the JAX scatter drops them with ``mode="drop"``; a torch index out
    of range would raise or wrap), so no pad ever lands in a real slot."""
    keep = np.asarray(slots) < cache.n_slots
    if not keep.any():
        return
    dev = cache.f_sk.device
    lanes_t = torch.from_numpy(np.asarray(lanes, np.int64)[keep]).to(dev)
    slots_t = torch.from_numpy(np.asarray(slots, np.int64)[keep]).to(dev)
    n = f_sk.shape[0] // 2
    for dst, src in ((cache.f_sk, f_sk), (cache.f_rf, f_rf)):
        dst.index_copy_(0, slots_t, torch.stack([src[lanes_t], src[n + lanes_t]], dim=1))


def _upload_slot(cache: CacheState, slot: int, f_sk: np.ndarray, f_rf: np.ndarray) -> None:
    """Promote one spill-resident capture back onto the device ring, in
    place: the reverse of the eviction demote, float32-lossless, so the
    promoted slot serves hits bit-identically to the original capture."""
    cache.f_sk[slot].copy_(torch.from_numpy(np.asarray(f_sk, np.float32)))
    cache.f_rf[slot].copy_(torch.from_numpy(np.asarray(f_rf, np.float32)))


def select_entry_features(
    own: torch.Tensor,  # [2N, L, C] lane-cache features
    cached: torch.Tensor,  # [S, 2, L, C] cache slots
    src: torch.Tensor,  # [N] int64 slot index per lane; -1 = own
    use: torch.Tensor | None = None,  # [N] bool consume mask (default: src >= 0)
) -> torch.Tensor:
    """Per-lane captured-vs-cached feature selection: a gather and a where,
    an exact passthrough where nothing is used.  ``use`` carries the
    micro-step's device-side threshold comparison."""
    n = own.shape[0] // 2
    pick = cached[torch.clamp(src, 0, cached.shape[0] - 1)]  # [N, 2, L, C]
    if use is None:
        use = src >= 0
    use = use[:, None, None]
    cond = torch.where(use, pick[:, 0], own[:n])
    unc = torch.where(use, pick[:, 1], own[n:])
    return torch.cat([cond, unc], dim=0)


class _GenClock:
    """Generation counter that every key write ticks; the sharded cache
    gives one to all its rings, so slot generations are ordered across
    rings and one ``since`` cursor drives ``keys_delta``."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0


@dataclasses.dataclass
class SpillEntry:
    """One demoted capture parked in host RAM (features included)."""

    bucket: int
    offset: int
    rid: int
    sig: np.ndarray  # [sig_dim] float32
    f_sk: np.ndarray  # [2, L_sk, C_sk] float32
    f_rf: np.ndarray  # [2, L_rf, C_rf] float32
    nbytes: int


class SpillRing:
    """Host-RAM spill tier under the device slot ring: a byte-capped LRU of
    demoted feature captures, keyed by ``(rid, bucket, offset)``.

    Ring evictions :meth:`put` the victim's features here (numpy copies,
    float32-lossless) instead of dropping them; admission probes the spill
    with the device ring's key policy and promotes a match back onto a
    device slot before the lane's first planned FULL step.
    """

    def __init__(self, capacity_bytes: int, *, mode: str = "cross"):
        if capacity_bytes < 0:
            raise ValueError("spill capacity must be >= 0 bytes")
        self.capacity_bytes = int(capacity_bytes)
        self.mode = mode
        self._entries: OrderedDict[tuple, SpillEntry] = OrderedDict()
        self.reset()

    def __len__(self) -> int:
        return len(self._entries)

    def reset(self) -> None:
        self._entries.clear()
        self.bytes = 0
        self.demotions = 0
        self.promotions = 0
        self.spill_evictions = 0

    def put(
        self, bucket: int, offset: int, rid: int, sig: np.ndarray,
        f_sk: np.ndarray, f_rf: np.ndarray,
    ) -> bool:
        """Admit (or refresh) one demoted capture; False = too big to hold."""
        f_sk = np.ascontiguousarray(f_sk, np.float32)
        f_rf = np.ascontiguousarray(f_rf, np.float32)
        nbytes = f_sk.nbytes + f_rf.nbytes
        if nbytes > self.capacity_bytes:
            return False
        key = (int(rid), int(bucket), int(offset))
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
        while self.bytes + nbytes > self.capacity_bytes and self._entries:
            _, victim = self._entries.popitem(last=False)
            self.bytes -= victim.nbytes
            self.spill_evictions += 1
        self._entries[key] = SpillEntry(
            bucket=int(bucket), offset=int(offset), rid=int(rid),
            sig=np.asarray(sig, np.float32).copy(),
            f_sk=f_sk, f_rf=f_rf, nbytes=nbytes,
        )
        self.bytes += nbytes
        self.demotions += 1
        return True

    def probe(
        self, bucket: int, sig: np.ndarray, rid: int, threshold: float,
        offset: int = 0,
    ) -> SpillEntry | None:
        """Best spill entry for (bucket, signature, offset) under the device
        ring's strict hit rule and mode scope, with an LRU touch on the match."""
        if threshold <= 0 or not self._entries:
            return None
        best_key, best_d = None, np.inf
        for key, e in self._entries.items():
            if e.bucket != bucket or e.offset != offset:
                continue
            if (e.rid == rid) != (self.mode == "intra"):
                continue
            d = signature_distance(sig, e.sig)
            if d < best_d:
                best_key, best_d = key, d
        if best_key is None or not best_d < threshold:
            return None
        self._entries.move_to_end(best_key)
        return self._entries[best_key]

    def stats(self) -> dict:
        return {
            "cache_spill_capacity_bytes": self.capacity_bytes,
            "cache_spill_bytes": self.bytes,
            "cache_spill_entries": len(self._entries),
            "cache_spill_demotions": self.demotions,
            "cache_spill_promotions": self.promotions,
            "cache_spill_evictions": self.spill_evictions,
        }


class SlotRing:
    """Host-side slot metadata and the hit/eviction policy of one ring:
    everything but the device feature tensors, as O(S) numpy."""

    def __init__(
        self,
        n_slots: int,
        sig_dim: int,
        *,
        threshold: float = 0.15,
        t_bucket: int = 125,
        mode: str = "cross",
    ):
        if mode not in ("intra", "cross"):
            raise ValueError(f"cache mode must be 'intra' or 'cross', got {mode!r}")
        if n_slots < 1:
            raise ValueError("cache needs at least one slot")
        if threshold < 0:
            raise ValueError("cache threshold must be >= 0")
        if t_bucket < 1:
            raise ValueError("timestep bucket width must be >= 1")
        self.mode = mode
        self.n_slots = n_slots
        self.threshold = threshold
        self.t_bucket = t_bucket
        self.sig_dim = sig_dim
        #: eviction hook, called with the victim slot before its keys are
        #: overwritten (features still on the device): the spill demotes here
        self.on_evict = None
        #: generation clock; the sharded cache shares one across its rings
        self._clock = _GenClock()
        self.reset_meta()

    def reset_meta(self) -> None:
        """Drop all slot keys and counters (cold ring)."""
        s = self.n_slots
        self.bucket = np.full((s,), -1, np.int64)
        self.sig = np.zeros((s, self.sig_dim), np.float32)
        self.rid = np.full((s,), -1, np.int64)
        #: schedule offset (base - executed steps) the slot was captured
        #: under: warm hits never cross incompatible img2img truncations
        self.offset = np.zeros((s,), np.int64)
        self.valid = np.zeros((s,), bool)
        self.last_use = np.zeros((s,), np.int64)
        #: per-slot generation stamp (the value of ``version`` at the slot's
        #: last key write): ``key_delta(since)`` ships only newer slots
        self.gen = np.zeros((s,), np.int64)
        self._clock.value = 0
        self._tick = 0
        self.probes = 0
        self.probe_hits = 0
        self.inserts = 0
        self.evictions = 0

    @property
    def version(self) -> int:
        """Generation of the newest key write (0 = cold ring)."""
        return self._clock.value

    def bucket_of(self, t: int) -> int:
        return int(t) // self.t_bucket

    @property
    def n_warm(self) -> int:
        return int(self.valid.sum())

    def _touch(self, slot: int) -> None:
        self._tick += 1
        self.last_use[slot] = self._tick

    # -- lookup --------------------------------------------------------------

    def probe_distance(
        self, t: int, sig: np.ndarray, rid: int, threshold: float | None = None,
        offset: int = 0,
    ) -> tuple[int, float] | None:
        """Best matching warm slot for (timestep, signature, schedule offset)
        with its float32 signature distance, or None.  ``threshold`` is the
        request's own bound (None = the ring default).  Read-only: no
        counters, no LRU touch."""
        thr = self.threshold if threshold is None else threshold
        mask = self.valid & (self.bucket == self.bucket_of(t)) & (self.offset == offset)
        mask &= (self.rid == rid) if self.mode == "intra" else (self.rid != rid)
        if not mask.any():
            return None
        d = np.linalg.norm(self.sig - np.asarray(sig, np.float32), axis=1)
        d = d / (np.linalg.norm(self.sig, axis=1) + 1e-12)
        d = np.where(mask, d, np.inf).astype(np.float32)
        best = int(np.argmin(d))
        # strict: threshold 0 never hits; the float32 distance is also what
        # the micro-step re-compares against the lane's threshold leaf
        return (best, float(d[best])) if d[best] < thr else None

    def probe(
        self, t: int, sig: np.ndarray, rid: int, threshold: float | None = None,
        offset: int = 0,
    ) -> int | None:
        """Slot-only convenience over :meth:`probe_distance`."""
        hit = self.probe_distance(t, sig, rid, threshold, offset)
        return None if hit is None else hit[0]

    def note_hit(self, slot: int) -> None:
        """An executed demotion consumed ``slot``: count it + touch LRU."""
        self.probes += 1
        self.probe_hits += 1
        self._touch(slot)

    def note_miss(self) -> None:
        """A probed step executed as planned (no warm slot matched)."""
        self.probes += 1

    def plan_warmth(self, req, shard: int | None = None) -> float:
        """Fraction of a queued request's FULL steps that would hit now,
        probed at the request's own per-step thresholds.  ``shard`` is
        ignored: one ring and the sharded cache share a signature.
        Duck-typed on the engine's ``GenRequest`` (``_lane_plan``,
        ``_sig``); anything else scores 0."""
        lp = getattr(req, "_lane_plan", None)
        sig = getattr(req, "_sig", None)
        if lp is None or sig is None or not self.valid.any():
            return 0.0
        thr = getattr(lp, "thr", None)
        off = int(getattr(req, "sched_offset", 0))
        hits, fulls = 0, 0
        for i in range(lp.n_steps):
            if lp.branches[i] != SM.FULL:
                continue
            fulls += 1
            step_thr = None if thr is None or i >= len(thr) else float(thr[i])
            if self.probe(
                int(lp.ts[i]), sig, getattr(req, "rid", -1), step_thr, off
            ) is not None:
                hits += 1
        return hits / max(fulls, 1)

    # -- insert --------------------------------------------------------------

    def reserve(
        self, t: int, sig: np.ndarray, rid: int, exclude: set[int] | tuple = (),
        offset: int = 0,
    ) -> int | None:
        """Claim a slot for (t, sig, rid, offset) and update the host keys.

        A valid slot already holding (rid, bucket, offset) is refreshed in
        place; otherwise the first empty slot; otherwise the LRU slot is
        evicted.  ``exclude`` holds slots this micro-step's batch already
        claimed; None when every slot is excluded (ring smaller than the
        batch: that capture goes uncached).
        """
        b = self.bucket_of(t)
        free = np.ones((self.n_slots,), bool)
        for s in exclude:
            free[s] = False
        same = np.nonzero(
            free & self.valid & (self.rid == rid) & (self.bucket == b)
            & (self.offset == offset)
        )[0]
        if same.size:
            slot = int(same[0])
        else:
            empty = np.nonzero(free & ~self.valid)[0]
            if empty.size:
                slot = int(empty[0])
            else:
                avail = np.nonzero(free)[0]
                if not avail.size:
                    return None
                slot = int(avail[np.argmin(self.last_use[avail])])
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(slot)  # keys and features still intact
        self.bucket[slot] = b
        self.sig[slot] = np.asarray(sig, np.float32)
        self.rid[slot] = rid
        self.offset[slot] = offset
        self.valid[slot] = True
        self._clock.value += 1
        self.gen[slot] = self._clock.value
        self.inserts += 1
        self._touch(slot)
        return slot

    # -- reporting -----------------------------------------------------------

    def counters(self) -> dict:
        return {
            "cache_probes": self.probes,
            "cache_probe_hits": self.probe_hits,
            "cache_inserts": self.inserts,
            "cache_evictions": self.evictions,
        }

    def _slot_row(self, s: int) -> dict:
        return {
            "slot": int(s),
            "gen": int(self.gen[s]),
            "bucket": int(self.bucket[s]),
            "offset": int(self.offset[s]),
            "rid": int(self.rid[s]),
            "sig": [round(float(x), 4) for x in self.sig[s]],
        }

    def slot_summary(self) -> list[dict]:
        """Wire keys of the warm slots (slot, generation stamp, bucket,
        schedule offset, owner rid, prompt signature to 4 digits; never the
        features), as ``GET /stats`` publishes them.  Past
        :data:`MAX_SUMMARY_SLOTS` warm slots only the most recently used
        are reported."""
        warm = np.nonzero(self.valid)[0]
        if warm.size > MAX_SUMMARY_SLOTS:
            keep = warm[np.argsort(self.last_use[warm])][-MAX_SUMMARY_SLOTS:]
            warm = np.sort(keep)
        return [self._slot_row(int(s)) for s in warm]

    def key_delta(self, since: int = 0) -> list[dict]:
        """Warm-slot rows written after generation ``since`` (rows as in
        :meth:`slot_summary`; a consumer merges them by slot index), capped
        at the :data:`MAX_SUMMARY_SLOTS` newest generations."""
        fresh = np.nonzero(self.valid & (self.gen > int(since)))[0]
        if fresh.size > MAX_SUMMARY_SLOTS:
            keep = fresh[np.argsort(self.gen[fresh])][-MAX_SUMMARY_SLOTS:]
            fresh = np.sort(keep)
        return [self._slot_row(int(s)) for s in fresh]


class FeatureCache(SlotRing):
    """Fixed-size LRU feature cache: device slots + host keys, owned by one
    :class:`~repro_torch.serving.engine.DiffusionEngine`, which probes before
    each micro-step, hands the winning slot per lane to the micro-step, and
    inserts fresh FULL-step captures after it."""

    def __init__(
        self,
        ucfg: UNetConfig,
        e_sk: int,
        e_rf: int,
        *,
        n_slots: int = 16,
        threshold: float = 0.15,
        t_bucket: int = 125,
        mode: str = "cross",
        spill_mb: float = 0.0,
        device="cpu",
    ):
        self._sk_shape = (n_slots, 2) + SM.feat_shape(ucfg, e_sk, 1)[1:]
        self._rf_shape = (n_slots, 2) + SM.feat_shape(ucfg, e_rf, 1)[1:]
        self._device = device
        super().__init__(
            n_slots, sig_dim(ucfg), threshold=threshold, t_bucket=t_bucket, mode=mode
        )
        self.spill: SpillRing | None = None
        if spill_mb > 0:
            self.spill = SpillRing(int(spill_mb * 1024 * 1024), mode=mode)
            self.on_evict = self._demote
        self.state = CacheState(
            f_sk=torch.zeros(self._sk_shape, device=device),
            f_rf=torch.zeros(self._rf_shape, device=device),
        )

    def reset(self) -> None:
        """Drop all slots and counters (cold cache)."""
        self.reset_meta()
        if self.spill is not None:
            self.spill.reset()
        self.state.f_sk.zero_()
        self.state.f_rf.zero_()

    # -- spill tier ----------------------------------------------------------

    def _demote(self, slot: int) -> None:
        """Eviction hook: park the victim's features in host RAM under its
        old key (a float32 copy off the device, one sync per eviction)."""
        if not self.valid[slot]:
            return
        self.spill.put(
            int(self.bucket[slot]), int(self.offset[slot]), int(self.rid[slot]),
            self.sig[slot],
            # copies even on the CPU, where .cpu() would alias the slot that
            # the caller is about to overwrite
            self.state.f_sk[slot].to("cpu", copy=True).numpy(),
            self.state.f_rf[slot].to("cpu", copy=True).numpy(),
        )

    def promote(
        self, t: int, sig: np.ndarray, rid: int, threshold: float | None = None,
        offset: int = 0, exclude: set[int] | tuple = (),
    ) -> int | None:
        """Probe the spill tier for (t, sig, offset) and lift a match back
        onto a device slot (reserve + upload).  The slot keeps the original
        owner's rid, so cross-mode reuse by the requester works and
        self-reuse stays barred; the entry stays spill-resident.  Returns
        the device slot or None."""
        if self.spill is None:
            return None
        thr = self.threshold if threshold is None else threshold
        entry = self.spill.probe(self.bucket_of(t), sig, rid, thr, offset)
        if entry is None:
            return None
        slot = self.reserve(
            entry.bucket * self.t_bucket, entry.sig, entry.rid,
            exclude=exclude, offset=entry.offset,
        )
        if slot is None:
            return None
        _upload_slot(self.state, slot, entry.f_sk, entry.f_rf)
        self.spill.promotions += 1
        return slot

    # -- device insert -------------------------------------------------------

    def insert_many(
        self, f_sk: torch.Tensor, f_rf: torch.Tensor, lanes: np.ndarray, slots: np.ndarray
    ) -> None:
        """Fill reserved slots from the lane caches in one indexed copy;
        entries with ``slots[i] >= n_slots`` are padding and are skipped."""
        _insert_slots(self.state, f_sk, f_rf, lanes, slots)

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "cache_mode": self.mode,
            "cache_slots": self.n_slots,
            "cache_warm_slots": self.n_warm,
            **self.counters(),
        }
        if self.spill is not None:
            out.update(self.spill.stats())
        return out

    def slots_summary(self) -> dict:
        """Ring geometry and warm-slot keys, as ``GET /stats`` publishes
        them.  A consumer that keeps ``version`` asks :meth:`keys_delta`
        for the changes since (and treats a version that went backwards as
        a restart)."""
        return {
            "mode": self.mode,
            "threshold": self.threshold,
            "t_bucket": self.t_bucket,
            "version": self.version,
            "rings": [self.slot_summary()],
        }

    def keys_delta(self, since: int = 0) -> dict:
        """Incremental form of :meth:`slots_summary`: only slots whose key
        generation exceeds ``since`` (the ``GET /cache/keys`` payload)."""
        return {
            "mode": self.mode,
            "threshold": self.threshold,
            "t_bucket": self.t_bucket,
            "version": self.version,
            "since": int(since),
            "rings": [self.key_delta(since)],
        }


class ShardedFeatureCache:
    """Shard-local slot rings for the sharded engine, over one shared spill.

    Shard ``d`` owns a :class:`SlotRing` of ``slots_per_shard`` slots whose
    device features (:class:`CacheState`, ``state[d]``) live on the shard's
    own device, so a hit is a gather on that device and reuse never moves
    features between shards.  The rings share one generation clock (one
    cursor drives ``keys_delta`` over all of them) and one host-RAM
    :class:`SpillRing`: a capture demoted off shard A's ring can be promoted
    onto shard B's, the one path by which features cross shards.  Slot
    indices at this API are shard-local, as the sharded micro-step consumes
    them.
    """

    def __init__(
        self,
        ucfg: UNetConfig,
        e_sk: int,
        e_rf: int,
        devices,
        *,
        slots_per_shard: int = 16,
        threshold: float = 0.15,
        t_bucket: int = 125,
        mode: str = "cross",
        spill_mb: float = 0.0,
    ):
        self.n_shards = len(devices)
        self.slots_per_shard = slots_per_shard
        self.mode = mode
        self.threshold = threshold
        self.t_bucket = t_bucket
        self.rings = [
            SlotRing(slots_per_shard, sig_dim(ucfg), threshold=threshold, t_bucket=t_bucket,
                     mode=mode)
            for _ in devices
        ]
        for ring in self.rings[1:]:
            ring._clock = self.rings[0]._clock
        self.spill: SpillRing | None = None
        if spill_mb > 0:
            self.spill = SpillRing(int(spill_mb * 1024 * 1024), mode=mode)
            for d, ring in enumerate(self.rings):
                ring.on_evict = functools.partial(self._demote, d)
        sk = (slots_per_shard, 2) + SM.feat_shape(ucfg, e_sk, 1)[1:]
        rf = (slots_per_shard, 2) + SM.feat_shape(ucfg, e_rf, 1)[1:]
        #: per shard, its device slots on its own device
        self.state = [
            CacheState(f_sk=torch.zeros(sk, device=dev), f_rf=torch.zeros(rf, device=dev))
            for dev in devices
        ]

    def reset(self) -> None:
        """Drop every ring's slots and counters, and the spill (cold cache)."""
        for ring in self.rings:
            ring.reset_meta()
        if self.spill is not None:
            self.spill.reset()
        for st in self.state:
            st.f_sk.zero_()
            st.f_rf.zero_()

    # -- spill tier ----------------------------------------------------------

    def _demote(self, shard: int, slot: int) -> None:
        """Ring ``shard``'s eviction hook: copy the victim off the shard's
        device into the shared spill under its old key."""
        ring, st = self.rings[shard], self.state[shard]
        if not ring.valid[slot]:
            return
        self.spill.put(
            int(ring.bucket[slot]), int(ring.offset[slot]), int(ring.rid[slot]), ring.sig[slot],
            st.f_sk[slot].to("cpu", copy=True).numpy(),
            st.f_rf[slot].to("cpu", copy=True).numpy(),
        )

    def promote(
        self, shard: int, t: int, sig: np.ndarray, rid: int,
        threshold: float | None = None, offset: int = 0, exclude: set[int] | tuple = (),
    ) -> int | None:
        """Lift a spill-resident match onto shard ``shard``'s ring, whichever
        shard demoted it (:meth:`FeatureCache.promote`, the owner rid kept).
        Returns the shard-local slot or None."""
        if self.spill is None:
            return None
        ring = self.rings[shard]
        thr = ring.threshold if threshold is None else threshold
        entry = self.spill.probe(ring.bucket_of(t), sig, rid, thr, offset)
        if entry is None:
            return None
        slot = ring.reserve(entry.bucket * self.t_bucket, entry.sig, entry.rid,
                            exclude=exclude, offset=entry.offset)
        if slot is None:
            return None
        _upload_slot(self.state[shard], slot, entry.f_sk, entry.f_rf)
        self.spill.promotions += 1
        return slot

    # -- shard-local metadata ------------------------------------------------

    def probe(
        self, shard: int, t: int, sig: np.ndarray, rid: int,
        threshold: float | None = None, offset: int = 0,
    ) -> int | None:
        return self.rings[shard].probe(t, sig, rid, threshold, offset)

    def probe_distance(
        self, shard: int, t: int, sig: np.ndarray, rid: int,
        threshold: float | None = None, offset: int = 0,
    ) -> tuple[int, float] | None:
        return self.rings[shard].probe_distance(t, sig, rid, threshold, offset)

    def note_hit(self, shard: int, slot: int) -> None:
        self.rings[shard].note_hit(slot)

    def note_miss(self, shard: int) -> None:
        self.rings[shard].note_miss()

    def reserve(
        self, shard: int, t: int, sig: np.ndarray, rid: int,
        exclude: set[int] | tuple = (), offset: int = 0,
    ) -> int | None:
        return self.rings[shard].reserve(t, sig, rid, exclude=exclude, offset=offset)

    def plan_warmth(self, req, shard: int | None = None) -> float:
        """Warmth on one shard's ring, or on the warmest ring when unpinned."""
        if shard is not None:
            return self.rings[shard].plan_warmth(req)
        return max(ring.plan_warmth(req) for ring in self.rings)

    @property
    def n_warm(self) -> int:
        return sum(ring.n_warm for ring in self.rings)

    # -- device insert -------------------------------------------------------

    def insert_many(self, f_sk, f_rf, lanes: np.ndarray, slots: np.ndarray) -> None:
        """Fill reserved slots from each shard's lane caches (``f_sk[d]`` /
        ``f_rf[d]``, shard ``d``'s ``[2P, ...]`` tensors), one indexed copy a
        shard.  ``lanes`` / ``slots`` hold shard-local indices in per-shard
        segments (positions ``[d * P, (d + 1) * P)`` are shard ``d``'s);
        entries with ``slots[i] >= slots_per_shard`` are padding and dropped."""
        p = len(lanes) // self.n_shards
        for d, st in enumerate(self.state):
            seg = slice(d * p, (d + 1) * p)
            _insert_slots(st, f_sk[d], f_rf[d], lanes[seg], slots[seg])

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        out = {
            "cache_mode": self.mode,
            "cache_shards": self.n_shards,
            "cache_slots": self.n_shards * self.slots_per_shard,
            "cache_warm_slots": self.n_warm,
            "cache_probes": sum(r.probes for r in self.rings),
            "cache_probe_hits": sum(r.probe_hits for r in self.rings),
            "cache_inserts": sum(r.inserts for r in self.rings),
            "cache_evictions": sum(r.evictions for r in self.rings),
            "shard_hit_rates": [
                round(r.probe_hits / r.probes, 3) if r.probes else 0.0 for r in self.rings
            ],
        }
        if self.spill is not None:
            out.update(self.spill.stats())
        return out

    @property
    def version(self) -> int:
        """Newest key generation over all rings (the shared clock)."""
        return self.rings[0].version

    def slots_summary(self) -> dict:
        """Every ring's warm-slot keys under the shared ``version``
        (:meth:`FeatureCache.slots_summary`, one entry of ``rings`` a shard)."""
        return {
            "mode": self.mode,
            "threshold": self.threshold,
            "t_bucket": self.t_bucket,
            "version": self.version,
            "rings": [ring.slot_summary() for ring in self.rings],
        }

    def keys_delta(self, since: int = 0) -> dict:
        """Incremental form of :meth:`slots_summary` (``GET /cache/keys``)."""
        return {
            "mode": self.mode,
            "threshold": self.threshold,
            "t_bucket": self.t_bucket,
            "version": self.version,
            "since": int(since),
            "rings": [ring.key_delta(since) for ring in self.rings],
        }
