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
requests' slots.  The mesh-sharded rings are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.common.types import UNetConfig
from repro_torch.core import sampler as SM

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


def prompt_signature(ctx: np.ndarray) -> np.ndarray:
    """Pooled prompt-embedding signature used as the cache key ([ctx_dim])."""
    return np.asarray(ctx, np.float32).mean(axis=0)


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
        self._tick = 0
        self.probes = 0
        self.probe_hits = 0
        self.inserts = 0
        self.evictions = 0

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

    def plan_warmth(self, req) -> float:
        """Fraction of a queued request's FULL steps that would hit now,
        probed at the request's own per-step thresholds.  Duck-typed on the
        engine's ``GenRequest`` (``_lane_plan``, ``_sig``); anything else
        scores 0."""
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
            n_slots, ucfg.ctx_dim, threshold=threshold, t_bucket=t_bucket, mode=mode
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
