"""Integrity-verified content-addressed artifact cache for the serving
tier — counterpart of ``repro/serving/cache.py``.

Segmentation traffic is redundant: retries and hedges re-submit the same
scan, model sweeps run one atlas volume through every precision, and
shared reference volumes arrive from many clients. This tier keys, stores
and verifies the artifacts so the second identical request never touches
the card:

  * **Content-addressed keys** — an artifact is keyed by
    ``blake2b(volume bytes) + model fingerprint + precision + mode``:
    two byte-identical volumes served under the same model card, storage
    policy and inference mode produce the same segmentation. A volume's
    identity is its numpy dtype name, shape and bytes, whether it comes
    as a numpy array or as a tensor on the CPU or the card (a tensor on
    the card is copied to the host to be hashed), so the port derives the
    reference's keys for the same volume.
  * **Integrity re-verification on every hit** — the stored artifact's
    checksum is recomputed at serve time and compared against the
    checksum recorded at store time. A mismatch (bit rot, a torn write,
    an injected ``corrupt_entry`` fault) quarantines the entry and the
    request transparently recomputes. ``stats.quarantined_served``
    counts serves of unverified bytes and must stay 0.
  * **Single-flight stampede collapsing** — a miss registers an
    in-flight *pinned* placeholder; concurrent identical requests on the
    same replica attach to it as followers and complete with the
    leader's artifact (scheduler outcome ``coalesced``). N identical
    concurrent requests cost ONE execution.
  * **Negative caching** — a permanent-fault result is cached with a TTL
    so a poisoned signature does not re-burn retry budgets on every
    arrival; the verdict expires and is re-tested.
  * **Byte-accounted LRU** — capacity is a ``telemetry/budget.py``
    ``MemoryBudget``; every entry is charged its modeled artifact bytes
    (one label byte per voxel plus metadata, the reference's model: the
    int32 segmentation an executed entry holds on the card takes four),
    eviction walks least-recently-used first and never evicts a pinned
    in-flight entry.
  * **Fail-open degradation** — an unavailable or slow tier (injected
    ``cache_unavailable`` / ``slow_cache`` faults) degrades to the
    compute path, and a consecutive-failure breaker stops consulting a
    persistently faulty tier until a cooldown probe finds it healthy.

The cache stores whatever result object it is handed and hands the same
object back; the scheduler gives it a private copy and gives every hit
and follower a copy of its own (serving/scheduler.py), since a torch
segmentation, unlike a jax array, can be written in place.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.serving.errors import (
    CacheCorruptionError,
    CacheUnavailableError,  # noqa: F401  (re-exported: the taxonomy pair)
    PERMANENT_FAULT,
)
from repro_torch.telemetry.budget import MemoryBudget

#: artifact metadata overhead modeled per entry, on top of the label body.
_META_OVERHEAD_BYTES = 256


# ---------------------------------------------------------- key derivation ---


def content_hash(vol) -> Optional[str]:
    """The content identity of a volume, or None when it has none.

    Real arrays hash their bytes (plus shape and dtype, so a reshaped view
    cannot alias a different geometry); a torch tensor hashes as the numpy
    array of its values would (``_host_view``). The load simulator's shape
    stubs carry an explicit ``content_id`` token instead of bytes — the
    Zipf content-skew process assigns them — and hash (shape, token). A
    stub with no token is uncacheable: returning None makes the cache
    bypass it rather than invent an identity that would alias every
    request of one shape onto one artifact."""
    shape = getattr(vol, "shape", None)
    if shape is None:
        return None
    token = getattr(vol, "content_id", None)
    if token is not None:
        payload = repr(("stub", tuple(shape), token)).encode("utf-8")
        return hashlib.blake2b(payload, digest_size=16).hexdigest()
    host = _host_view(vol)
    if host is None:
        return None
    dtype_name, data = host
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((tuple(shape), dtype_name)).encode())
    h.update(data)
    return h.hexdigest()


def _host_view(vol) -> Optional[tuple[str, Any]]:
    """(dtype name, C-order bytes or a C-contiguous array) of a volume,
    or None. numpy arrays give ``str(dtype)`` ("float32"); a torch tensor
    gives its dtype's name without the ``torch.`` prefix, so a tensor and
    the numpy array of its values share one identity (bf16, which numpy
    lacks, hashes its raw 2-byte words as "bfloat16", ml_dtypes' name).
    A tensor on the card is copied to the host once; a contiguous array
    is hashed in place, with no copy into a ``bytes``."""
    if isinstance(vol, torch.Tensor):
        t = vol.detach().contiguous().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy()
    if isinstance(vol, np.ndarray):
        return str(vol.dtype), np.ascontiguousarray(vol)
    tobytes = getattr(vol, "tobytes", None)
    if tobytes is None:
        return None
    return str(getattr(vol, "dtype", "?")), tobytes()


def model_fingerprint(model_cfg) -> str:
    """Deterministic fingerprint of a model card: the cache must never
    serve one model's segmentation for another's request, so the whole
    architecture config is in the key."""
    payload = repr(model_cfg).encode("utf-8")
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


def artifact_key(content: str, model_fp: str, precision: str, mode: str) -> str:
    """The full cache key: content + model + precision + mode. Precision
    and mode are in the key because they change the *artifact* (an int8w
    subvolume segmentation is not the fp32 full-volume one), not just
    the cost of producing it."""
    payload = "|".join((content, model_fp, precision, mode)).encode("utf-8")
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


def artifact_bytes_modeled(shape) -> int:
    """Modeled stored size of one segmentation artifact: one label byte
    per voxel plus serialized metadata — the byte account LRU eviction
    charges against the cache's MemoryBudget."""
    return int(math.prod(tuple(shape)[:3])) + _META_OVERHEAD_BYTES


# ------------------------------------------------------------ configuration ---


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Artifact-cache policy knobs.

    ``capacity_bytes`` feeds a ``MemoryBudget`` (telemetry/budget.py) —
    the byte account every store charges and every eviction credits.
    ``verify_s`` is the modeled O(hash) cost of a lookup + integrity
    re-verification on the virtual clock (what a hit's ``service_s``
    records; a ``slow_cache`` fault multiplies it). ``negative_ttl_s``
    bounds how long a cached permanent-fault verdict suppresses
    recomputation. ``breaker_trip_after`` consecutive unavailable
    consults stop the tier being consulted for ``breaker_cooldown_s``."""

    capacity_bytes: int = 64 * 1024 * 1024
    negative_ttl_s: float = 120.0
    verify_s: float = 0.0005
    breaker_trip_after: int = 3
    breaker_cooldown_s: float = 60.0


@dataclasses.dataclass
class CacheStats:
    """The cache's observable ledger — every counter the golden traces,
    and ``telemetry/analysis.cache_summary`` pin."""

    lookups: int = 0
    hits: int = 0
    misses: int = 0
    inflight_hits: int = 0  # lookups answered "attach to the leader"
    negative_hits: int = 0
    stores: int = 0
    store_skips: int = 0  # stores dropped (tier down / nothing evictable)
    negative_stores: int = 0
    evictions: int = 0
    quarantined: int = 0  # corrupt entries caught by verification
    quarantined_served: int = 0  # corrupt bytes SERVED — must stay 0
    unavailable: int = 0  # consults lost to an unavailable tier
    slow_consults: int = 0
    breaker_trips: int = 0
    breaker_skips: int = 0  # consults skipped while the breaker is open
    bytes_stored: int = 0  # current byte account
    bytes_evicted: int = 0

    def hit_rate(self) -> float:
        consults = self.hits + self.misses + self.inflight_hits
        return (self.hits + self.inflight_hits) / max(consults, 1)


@dataclasses.dataclass
class _Entry:
    """One stored artifact (or negative verdict, or in-flight placeholder)."""

    key: str
    artifact: bytes
    checksum: str
    nbytes: int
    stored_s: float
    last_used_s: float
    meta: dict = dataclasses.field(default_factory=dict)
    result: Any = None  # in-memory PipelineResult for execute-mode hits
    pending: bool = False  # in-flight placeholder: pinned, not servable
    negative: bool = False
    fail_type: Optional[str] = None
    expires_s: float = math.inf


@dataclasses.dataclass(frozen=True)
class Lookup:
    """One consult's verdict. ``status``:

    ``hit``          — verified artifact in ``entry``; serve in O(hash).
    ``negative``     — cached permanent-fault verdict (non-expired).
    ``inflight``     — a leader owns this key; ``owner`` is its replica
                       (attach as a follower when it is the caller's).
    ``miss``         — compute; the caller may ``begin`` a leader entry.
    ``unavailable``  — the tier did not answer: fail open to compute.
    ``bypass``       — the cache breaker is open: fail open to compute.

    ``slow_factor`` scales the modeled verify cost under a ``slow_cache``
    fault (latency degradation, never correctness)."""

    status: str
    entry: Optional[_Entry] = None
    owner: Optional[int] = None
    slow_factor: float = 1.0


class _CacheBreaker:
    """Consecutive-unavailability breaker for the cache tier itself: a
    persistently faulty tier must not tax every request with a doomed
    consult. ``trip_after`` consecutive unavailable answers open it;
    after ``cooldown_s`` the next consult probes the tier and a healthy
    answer closes it. One breaker per cache — the tier is shared, so
    its health is too."""

    def __init__(self, trip_after: int, cooldown_s: float):
        self.trip_after = trip_after
        self.cooldown_s = cooldown_s
        self.consec = 0
        self.open = False
        self.opened_s = 0.0
        self.trips = 0

    def allow(self, now: float) -> bool:
        if not self.open:
            return True
        return now - self.opened_s >= self.cooldown_s  # half-open probe

    def on_unavailable(self, now: float) -> None:
        self.consec += 1
        if self.open:
            self.opened_s = now  # failed probe: fresh cooldown
            return
        if self.consec >= self.trip_after:
            self.open = True
            self.opened_s = now
            self.trips += 1

    def on_ok(self) -> None:
        self.consec = 0
        self.open = False


# ------------------------------------------------------------ the cache ---


class ArtifactCache:
    """The shared content-addressed artifact tier. One instance serves
    one scheduler or (through a fleet, serving/fleet.py) many — the
    instance IS the shared tier.

    All state transitions are pure in (calls, fault plan, seed): the
    injected fault decisions come from ``FaultPlan.decide_cache`` (a
    counter-hash, no RNG), timestamps come from the caller's virtual
    clock, and LRU order is tracked with explicit floats — so any
    scenario over this cache is byte-reproducible from (code, seed)."""

    def __init__(
        self,
        cfg: Optional[CacheConfig] = None,
        *,
        budget: Optional[MemoryBudget] = None,
        fault_plan=None,
    ):
        self.cfg = cfg or CacheConfig()
        self.budget = budget or MemoryBudget(
            bytes_limit=self.cfg.capacity_bytes, name="artifact_cache"
        )
        self.fault_plan = fault_plan
        self.entries: dict[str, _Entry] = {}
        self.inflight: dict[str, int] = {}  # key -> leader replica id
        self.stats = CacheStats()
        self.breaker = _CacheBreaker(
            self.cfg.breaker_trip_after, self.cfg.breaker_cooldown_s
        )

    # ---------------------------------------------------------- fault plumbing

    def _decide(self, op: str, *, now, replica, request_id, group_key):
        if self.fault_plan is None:
            return None
        decide = getattr(self.fault_plan, "decide_cache", None)
        if decide is None:
            return None
        return decide(
            t=now, replica=replica, key=group_key, request_id=request_id, op=op
        )

    # ------------------------------------------------------------- integrity

    @staticmethod
    def _checksum(artifact: bytes) -> str:
        return hashlib.blake2b(artifact, digest_size=16).hexdigest()

    @staticmethod
    def _corrupt(entry: _Entry) -> None:
        """Flip one byte of the stored artifact (deterministic position)
        — the injected bit-rot a ``corrupt_entry`` fault models. The
        verification path must catch this; nothing else may."""
        if not entry.artifact:
            return
        pos = entry.nbytes % len(entry.artifact)
        flipped = bytearray(entry.artifact)
        flipped[pos] ^= 0xFF
        entry.artifact = bytes(flipped)

    def _verified(self, entry: _Entry) -> bool:
        return self._checksum(entry.artifact) == entry.checksum

    def _quarantine(self, entry: _Entry) -> None:
        """Remove a corrupt entry from service: evicted, counted, and
        its bytes credited back. The caller recomputes transparently."""
        self.entries.pop(entry.key, None)
        self.stats.quarantined += 1
        self.stats.bytes_stored -= entry.nbytes

    def serve_payload(self, entry: _Entry) -> dict:
        """The artifact's metadata payload for synthesizing a hit record
        — re-verified AT SERVE TIME as a second independent guard: if
        corrupt bytes ever got this far, ``quarantined_served`` counts
        the breach, the entry is quarantined (so the store is clean when
        the caller's breach path recomputes as a fresh miss, and no
        other lookup can keep hitting the corrupt bytes), and a typed
        error aborts the serve. The counter is pinned to 0 by tests."""
        if not self._verified(entry):
            self.stats.quarantined_served += 1
            self._quarantine(entry)
            raise CacheCorruptionError(
                entry.key, entry.checksum, self._checksum(entry.artifact)
            )
        return json.loads(entry.artifact.decode("utf-8"))

    # --------------------------------------------------------------- consult

    def lookup(
        self,
        key: str,
        *,
        now: float,
        replica: int = 0,
        request_id: int = 0,
        group_key=None,
    ) -> Lookup:
        """One admission-time consult. Never raises: every fault answer
        is a typed ``Lookup`` status the caller degrades on fail-open."""
        slow = 1.0
        # breaker first: an open breaker means the tier is NOT consulted,
        # so no fault decision (which models a consult's outcome) is even
        # drawn — "stop consulting a persistently faulty tier" is literal.
        # decide_cache is a pure counter-hash, so skipping a draw cannot
        # perturb any other decision.
        if not self.breaker.allow(now):
            self.stats.breaker_skips += 1
            return Lookup(status="bypass")
        decision = self._decide(
            "lookup",
            now=now,
            replica=replica,
            request_id=request_id,
            group_key=group_key,
        )
        if decision is not None and decision.kind == "cache_unavailable":
            self.stats.unavailable += 1
            self.breaker.on_unavailable(now)
            return Lookup(status="unavailable")
        self.breaker.on_ok()
        if decision is not None and decision.kind == "slow_cache":
            slow = decision.slow_factor
            self.stats.slow_consults += 1
        self.stats.lookups += 1
        entry = self.entries.get(key)
        if entry is not None and not entry.pending:
            if entry.negative:
                if now < entry.expires_s:
                    entry.last_used_s = now
                    self.stats.negative_hits += 1
                    return Lookup(
                        status="negative", entry=entry, slow_factor=slow
                    )
                # verdict expired: drop it and re-test via compute
                self.entries.pop(key, None)
                self.stats.bytes_stored -= entry.nbytes
                entry = None
            else:
                if decision is not None and decision.kind == "corrupt_entry":
                    self._corrupt(entry)
                if self._verified(entry):
                    entry.last_used_s = now
                    self.stats.hits += 1
                    return Lookup(status="hit", entry=entry, slow_factor=slow)
                # integrity breach: quarantine + transparent recompute
                self._quarantine(entry)
                entry = None
        owner = self.inflight.get(key)
        if owner is not None:
            self.stats.inflight_hits += 1
            return Lookup(status="inflight", owner=owner, slow_factor=slow)
        self.stats.misses += 1
        return Lookup(status="miss", slow_factor=slow)

    # -------------------------------------------------------------- lifecycle

    def begin(
        self, key: str, *, replica: int, now: float, est_bytes: int
    ) -> None:
        """Register an in-flight leader: a PINNED placeholder entry
        reserving ``est_bytes`` that eviction may never touch — the
        leader's store must land even under byte pressure. Idempotent
        per key (a second leader for the same key on another replica
        keeps the first pin; stores are last-writer-wins)."""
        if key in self.inflight:
            return
        self.inflight[key] = replica
        if key not in self.entries:
            self._make_room(est_bytes, now)
            self.entries[key] = _Entry(
                key=key,
                artifact=b"",
                checksum="",
                nbytes=est_bytes,
                stored_s=now,
                last_used_s=now,
                pending=True,
            )
            self.stats.bytes_stored += est_bytes

    def abandon(self, key: str) -> None:
        """Drop an in-flight registration without a result (leader
        evacuated, cancelled, or crashed): unpin, and remove the
        placeholder so the byte account balances. Tolerant of unknown
        keys — failover paths may abandon twice."""
        self.inflight.pop(key, None)
        entry = self.entries.get(key)
        if entry is not None and entry.pending:
            self.entries.pop(key, None)
            self.stats.bytes_stored -= entry.nbytes

    def inflight_owner(self, key: str) -> Optional[int]:
        return self.inflight.get(key)

    def complete(
        self,
        key: str,
        *,
        now: float,
        record,
        result=None,
        shape=(0, 0, 0),
        replica: int = 0,
        request_id: int = 0,
    ) -> Optional[str]:
        """Fold a leader's terminal record into the store: a served
        ``ok`` record becomes a verified artifact, a permanent fault
        becomes a negative entry with TTL, anything else (exhausted
        transient, timeout) just unpins — retrying later may succeed,
        so no verdict is cached. Returns the stored artifact checksum
        (None when nothing was stored).

        The unpin is OWNER-CHECKED: a stale leader (its pin abandoned by
        drain/evacuate, the lead since re-taken by another replica) may
        still complete here, and it must not steal the current leader's
        pin or placeholder — it only stores (last-writer-wins), with the
        displaced entry's bytes credited by ``_displace``."""
        if self.inflight.get(key) == replica:
            self.inflight.pop(key, None)
            placeholder = self.entries.get(key)
            if placeholder is not None and placeholder.pending:
                self.entries.pop(key, None)
                self.stats.bytes_stored -= placeholder.nbytes
        decision = self._decide(
            "store",
            now=now,
            replica=replica,
            request_id=request_id,
            group_key=None,
        )
        if decision is not None and decision.kind == "cache_unavailable":
            self.stats.unavailable += 1
            self.stats.store_skips += 1
            self.breaker.on_unavailable(now)
            return None
        if record.status == "ok":
            payload = {
                "status": record.status,
                "mode": record.mode,
                "executor": record.executor,
                "precision": record.precision,
                "params_bytes": record.params_bytes,
                "hbm_bytes_modeled": record.hbm_bytes_modeled,
                "collective_bytes_modeled": record.collective_bytes_modeled,
            }
            artifact = json.dumps(payload, sort_keys=True).encode("utf-8")
            nbytes = artifact_bytes_modeled(shape) + len(artifact)
            if not self._make_room(nbytes, now):
                self.stats.store_skips += 1  # everything pinned: no room
                return None
            self._displace(key)
            checksum = self._checksum(artifact)
            entry = _Entry(
                key=key,
                artifact=artifact,
                checksum=checksum,
                nbytes=nbytes,
                stored_s=now,
                last_used_s=now,
                meta=payload,
                result=result,
            )
            self.entries[key] = entry
            self.stats.bytes_stored += nbytes
            self.stats.stores += 1
            if decision is not None and decision.kind == "corrupt_entry":
                # poison at rest: a later hit MUST quarantine this entry
                self._corrupt(entry)
            return checksum
        if record.fail_type == PERMANENT_FAULT:
            nbytes = _META_OVERHEAD_BYTES
            if not self._make_room(nbytes, now):
                self.stats.store_skips += 1
                return None
            self._displace(key)
            self.entries[key] = _Entry(
                key=key,
                artifact=b"",
                checksum="",
                nbytes=nbytes,
                stored_s=now,
                last_used_s=now,
                negative=True,
                fail_type=record.fail_type,
                expires_s=now + self.cfg.negative_ttl_s,
            )
            self.stats.bytes_stored += nbytes
            self.stats.negative_stores += 1
        return None

    # -------------------------------------------------------------- eviction

    def _displace(self, key: str) -> None:
        """Credit and remove whatever entry currently sits at ``key``
        immediately before a store lands there: last-writer-wins must
        not leak the displaced entry's bytes from the account (a stale
        entry surviving a quarantine race, or another leader's pending
        placeholder being overwritten — its PIN stays with its owner,
        only the bytes move). Called after ``_make_room``, so the room
        check is conservative by the displaced entry's size — it may
        evict one extra LRU entry, never under-reserve."""
        existing = self.entries.pop(key, None)
        if existing is not None:
            self.stats.bytes_stored -= existing.nbytes

    def _make_room(self, need: int, now: float) -> bool:
        """Evict least-recently-used entries until ``need`` fits the
        MemoryBudget. Pinned in-flight placeholders are NEVER victims —
        if only pinned entries remain and the budget still does not fit,
        the store is refused instead (the caller counts a skip). Ties on
        last-use break on key, so eviction order is deterministic."""
        limit = self.budget.bytes_limit
        if need > limit:
            return False  # one artifact larger than the whole tier
        while self.stats.bytes_stored + need > limit:
            victims = [
                e
                for k, e in self.entries.items()
                if k not in self.inflight and not e.pending
            ]
            if not victims:
                return False
            victim = min(victims, key=lambda e: (e.last_used_s, e.key))
            self.entries.pop(victim.key, None)
            self.stats.bytes_stored -= victim.nbytes
            self.stats.evictions += 1
            self.stats.bytes_evicted += victim.nbytes
        return True

    # --------------------------------------------------------------- rollups

    def summary(self) -> dict:
        """Deterministic counter rollup — the golden-trace face of the
        cache tier (merged into FleetReport.summary's ``cache`` block)."""
        s = self.stats
        return {
            "lookups": s.lookups,
            "hits": s.hits,
            "misses": s.misses,
            "inflight_hits": s.inflight_hits,
            "hit_rate": round(s.hit_rate(), 4),
            "negative_hits": s.negative_hits,
            "stores": s.stores,
            "store_skips": s.store_skips,
            "negative_stores": s.negative_stores,
            "evictions": s.evictions,
            "quarantined": s.quarantined,
            "quarantined_served": s.quarantined_served,
            "unavailable": s.unavailable,
            "slow_consults": s.slow_consults,
            "breaker_trips": s.breaker_trips + self.breaker.trips,
            "breaker_skips": s.breaker_skips,
            "bytes_stored": s.bytes_stored,
            "bytes_evicted": s.bytes_evicted,
            "entries": len(self.entries),
            "inflight": len(self.inflight),
        }


# ---------------------------------------------------------- conform memo ---


class ConformMemo:
    """Content-keyed memo for the conform stage (core/conform.py): the
    most expensive preprocessing step is pure in (volume bytes, target
    shape), so repeated submissions of one scan pay it once. Bounded by
    entry count with FIFO replacement — conformed volumes are large and
    this memo is a preprocessing accelerator, not the artifact store."""

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self.entries: dict[tuple, Any] = {}
        self._order: list[tuple] = []
        self.hits = 0
        self.misses = 0
        # (volume, out_shape, key) of the last miss: the pipeline's ``put``
        # after a miss hands back the same volume, which is not hashed twice
        self._missed: Optional[tuple] = None

    def _key(self, vol, out_shape) -> Optional[tuple]:
        content = content_hash(vol)
        if content is None:
            return None
        return (content, tuple(out_shape))

    def get(self, vol, out_shape):
        key = self._key(vol, out_shape)
        if key is not None and key in self.entries:
            self.hits += 1
            self._missed = None
            return self.entries[key]
        self.misses += 1
        self._missed = (vol, tuple(out_shape), key)
        return None

    def put(self, vol, out_shape, conformed) -> None:
        missed, self._missed = self._missed, None
        if missed is not None and missed[0] is vol and missed[1] == tuple(out_shape):
            key = missed[2]
        else:
            key = self._key(vol, out_shape)
        if key is None:
            return
        if key not in self.entries and len(self._order) >= self.max_entries:
            oldest = self._order.pop(0)
            self.entries.pop(oldest, None)
        if key not in self.entries:
            self._order.append(key)
        self.entries[key] = conformed
