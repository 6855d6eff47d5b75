"""Resilience layer — counterpart of ``repro/serving/resilience.py``:
retry/backoff, service timeouts, hedged re-dispatch, an executor
degradation ladder behind circuit breakers, and the seeded
fault-injection plans that make every failure scenario golden-testable.

Brainchop's promise is graceful degradation in a hostile runtime: when
the fast path fails, the tool falls back (the sub-volume failsafe, a
slower backend) instead of failing the user. This module supplies the
policy vocabulary the scheduler (serving/scheduler.py: retries,
timeouts, breakers) and a fleet (hedged re-dispatch) consume:

  * **RetryPolicy** — per-class retry budgets with exponential backoff
    and *seeded deterministic jitter* (a counter-based hash, not a global
    RNG): a retried request re-enters its signature lane with the
    ORIGINAL arrival stamp, so deadlines and FIFO stay honest and
    ``wait + service == finish - arrival`` keeps holding exactly.
  * **Service timeouts** — a per-priority-class bound on one attempt's
    service time (virtual seconds under the simulator): a stuck batch
    member is cancelled at the bound, charged the bound, stamped
    ``service_timeout``, and retried like a transient fault.
  * **HedgePolicy** — when a queued request's age crosses a p99-derived
    threshold, a fleet dispatches a second copy to another replica;
    first completion wins, the loser is cancelled.
  * **SignatureBreaker** — a per-(replica, signature) circuit breaker:
    ``trip_after`` consecutive executor faults demote the signature one
    rung down the degradation ladder (``LADDER``: cuda_megakernel ->
    cuda_fused -> torch -> streaming, then the sub-volume failsafe
    *mode*; on a CUDA device ``CARD_LADDER``, which stops at
    cuda_fused), re-resolving through the executor registry for the
    engine's device and re-pricing admission at the new rung; after
    ``cooldown_s`` a half-open probe retries the fast path and restores
    it on success. A demotion is logged in ``transitions`` and the
    record's ``executor`` says what ran.
  * **FaultPlan** — a seeded schedule of injected faults (transient
    raise, permanent raise, straggler slowdown, stuck-forever) keyed by
    (time-window, replica, signature): every injection decision is a
    pure function of (plan seed, replica, request id, attempt) and hashes
    no executor name, so the port's injector decides as the reference's
    does, draw for draw.

Pure Python: no tensor is touched here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional

from repro_torch.serving.errors import ResilienceConfigError

#: The executor degradation ladder, fastest rung first: the reference's
#: (pallas_megakernel, pallas_fused, xla, streaming) under the port's
#: names (``executors.REFERENCE_NAMES``). A breaker trip demotes a
#: signature's executor to the next rung (sharded wrappers demote their
#: inner backend and keep the slab count); below the last executor rung
#: sits the sub-volume failsafe *mode* — the same bottom rung Brainchop's
#: client falls back to, and the same form admission demotion produces.
LADDER = ("cuda_megakernel", "cuda_fused", "torch", "streaming")

#: The ladder on a CUDA device: the rungs that launch hand-written
#: kernels. A breaker on the card never demotes a signature onto the
#: plain forwards (``torch``, ``streaming``): from ``cuda_fused`` the walk
#: goes on to the sub-volume failsafe under ``cuda_fused``, so a kernel
#: that keeps failing fails its requests instead of being routed around.
CARD_LADDER = ("cuda_megakernel", "cuda_fused")

#: breaker states (per base signature, per scheduler == per replica).
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


def unit_hash(*parts) -> float:
    """Deterministic uniform draw in [0, 1) from integer/string parts —
    a counter-based hash (blake2b), NOT a stateful RNG: the same parts
    give the same draw on every platform and in any call order, which is
    what makes fault schedules and backoff jitter pure functions of
    (seed, request identity, attempt)."""
    h = hashlib.blake2b(repr(parts).encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64


# ----------------------------------------------------------------- retry ---


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget + backoff shape for retryable faults (transient
    executor faults and service timeouts; permanent faults never retry).

    ``max_attempts`` counts TOTAL service attempts (1 == no retries).
    The k-th retry (k >= 1) waits

        backoff = min(backoff_max_s, backoff_base_s * backoff_mult**(k-1))
                  * (1 + jitter_frac * (2u - 1)),   u = unit_hash(...)

    i.e. exponential growth, capped, with +/-``jitter_frac`` seeded
    jitter so synchronized fault bursts de-correlate their retries
    without a shared RNG (DESIGN.md §7.2)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ResilienceConfigError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.backoff_mult <= 0 or self.backoff_base_s < 0:
            raise ResilienceConfigError(
                "backoff_base_s must be >= 0 and backoff_mult > 0 "
                f"(got base={self.backoff_base_s}, mult={self.backoff_mult})"
            )
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ResilienceConfigError(
                f"jitter_frac must be in [0, 1), got {self.jitter_frac}"
            )

    def backoff_s(self, attempt: int, replica_id: int, request_id: int) -> float:
        """Deterministic backoff before service attempt ``attempt``
        (>= 1): exponential in the attempt index, jittered by a pure
        hash of (seed, replica, request, attempt)."""
        raw = min(
            self.backoff_max_s,
            self.backoff_base_s * self.backoff_mult ** (attempt - 1),
        )
        u = unit_hash("backoff", self.seed, replica_id, request_id, attempt)
        return raw * (1.0 + self.jitter_frac * (2.0 * u - 1.0))


# --------------------------------------------------------------- hedging ---


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Straggler hedging, run by the fleet (``serving/fleet.py``,
    ``Fleet._maybe_hedge``; a single scheduler only validates it): when a
    queued request's age exceeds ``max(min_age_s, p99_factor * p99)`` — p99
    taken over the last ``window`` served end-to-end latencies, once at
    least ``min_samples`` have been observed — a second copy is
    dispatched to another replica (never one already holding a copy).
    First completion wins; the loser is cancelled from its queue via the
    ledger. ``max_hedges`` bounds copies per request (1 == at most one
    hedge, i.e. two copies total)."""

    p99_factor: float = 3.0
    min_age_s: float = 1.0
    min_samples: int = 30
    window: int = 200
    max_hedges: int = 1

    def __post_init__(self):
        if self.p99_factor <= 0 or self.min_age_s < 0:
            raise ResilienceConfigError(
                "hedge p99_factor must be > 0 and min_age_s >= 0 "
                f"(got {self.p99_factor}, {self.min_age_s})"
            )
        if self.max_hedges < 1 or self.min_samples < 1 or self.window < 1:
            raise ResilienceConfigError(
                "hedge max_hedges/min_samples/window must all be >= 1"
            )


# ------------------------------------------------------- circuit breaker ---


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Per-(replica, signature) circuit-breaker law: ``trip_after``
    consecutive executor faults at the signature's current rung demote
    it one rung further down ``LADDER``; after ``cooldown_s`` the
    breaker half-opens and the next request of that signature probes the
    ORIGINAL (base) rung — success restores the fast path entirely,
    another fault re-opens for a fresh cooldown."""

    trip_after: int = 3
    cooldown_s: float = 30.0

    def __post_init__(self):
        if self.trip_after < 1 or self.cooldown_s < 0:
            raise ResilienceConfigError(
                "breaker trip_after must be >= 1 and cooldown_s >= 0 "
                f"(got {self.trip_after}, {self.cooldown_s})"
            )


@dataclasses.dataclass
class _BreakerEntry:
    """Mutable per-signature breaker state (keyed by the BASE GroupKey)."""

    rung: int = 0  # rungs below base the signature currently serves at
    consec_faults: int = 0  # consecutive faults at the current rung
    state: str = CLOSED
    opened_s: float = 0.0
    probing: bool = False  # a half-open probe is in flight at base rung


def signature_label(key) -> str:
    """Stable human-readable label of a dispatch signature for breaker
    transition logs and summaries."""
    shape = "x".join(str(s) for s in key.shape)
    return f"{key.mode}/{key.executor}/{key.precision}/{shape}"


class SignatureBreaker:
    """Circuit breakers for every dispatch signature of ONE scheduler
    (one scheduler == one fleet replica, so the keying is per
    (replica, signature) exactly as DESIGN.md §7.4 specifies). The
    scheduler consults ``effective_rung`` at batch formation and reports
    every execution result through ``on_result``; ``transitions`` is the
    state-change log the telemetry rollup surfaces."""

    def __init__(self, cfg: BreakerConfig):
        self.cfg = cfg
        self.entries: dict = {}  # base GroupKey -> _BreakerEntry
        self.transitions: list[dict] = []
        self.trips = 0
        self.restores = 0
        self.probes = 0

    def _log(self, key, entry: _BreakerEntry, to_state: str, now: float) -> None:
        entry.state = to_state
        self.transitions.append(
            {
                "t": round(float(now), 4),
                "signature": signature_label(key),
                "state": to_state,
                "rung": entry.rung,
            }
        )

    def _maybe_half_open(self, key, entry: _BreakerEntry, now: float) -> None:
        if (
            entry.state == OPEN
            and now - entry.opened_s >= self.cfg.cooldown_s
        ):
            self._log(key, entry, HALF_OPEN, now)

    def peek_rung(self, base_key, now: float) -> int:
        """The rung a request of this signature would serve at right now,
        WITHOUT claiming the half-open probe slot — what batch-formation
        uses to judge grouping candidates before admitting them."""
        entry = self.entries.get(base_key)
        if entry is None or entry.rung == 0:
            return 0
        self._maybe_half_open(base_key, entry, now)
        if entry.state == HALF_OPEN and not entry.probing:
            return 0  # the probe slot is free: this request would probe
        return entry.rung

    def effective_rung(self, base_key, now: float) -> tuple[int, bool]:
        """(rung, is_probe) for a request being admitted to a batch NOW.
        A half-open signature hands out exactly one probe slot: the probe
        serves at the base rung (0) and its result decides restore vs
        re-open; everyone else keeps the demoted rung meanwhile."""
        entry = self.entries.get(base_key)
        if entry is None or entry.rung == 0:
            return 0, False
        self._maybe_half_open(base_key, entry, now)
        if entry.state == HALF_OPEN and not entry.probing:
            entry.probing = True
            self.probes += 1
            return 0, True
        return entry.rung, False

    def on_result(
        self, base_key, *, fault: bool, probe: bool, now: float
    ) -> None:
        """Fold one execution result into the signature's breaker.
        ``fault`` is True for executor faults (transient, permanent, or
        a service timeout) — both flavours count toward the trip: a
        permanently-faulting signature must walk DOWN the ladder until
        it reaches a rung that serves, which is the whole point of
        degradation (requests complete slower instead of failing)."""
        entry = self.entries.get(base_key)
        if entry is None:
            if not fault:
                return
            entry = self.entries.setdefault(base_key, _BreakerEntry())
        if probe:
            entry.probing = False
            if fault:
                entry.opened_s = now  # fast path still broken: re-open
                self._log(base_key, entry, OPEN, now)
            else:
                entry.rung = 0  # fast path restored entirely
                entry.consec_faults = 0
                self.restores += 1
                self._log(base_key, entry, CLOSED, now)
            return
        if not fault:
            entry.consec_faults = 0
            return
        entry.consec_faults += 1
        if entry.consec_faults >= self.cfg.trip_after:
            entry.consec_faults = 0
            entry.rung += 1  # the ladder walk caps at its bottom rung
            entry.opened_s = now
            self.trips += 1
            self._log(base_key, entry, OPEN, now)

    def open_signatures(self) -> int:
        return sum(1 for e in self.entries.values() if e.rung > 0)

    def open_signature_labels(self) -> list:
        """Sorted labels of every signature currently held off its fast
        path (rung > 0) — the golden-trace face of the breaker state."""
        return sorted(
            signature_label(k)
            for k, e in self.entries.items()
            if e.rung > 0
        )


def demote_rung(key, engine):
    """ONE rung down the degradation ladder for ``key``, re-resolved
    through the executor registry for the engine's device — or None at
    the bottom. Executor rungs demote along ``LADDER`` (sharded wrappers
    demote their inner and keep the slab pin while the demoted inner
    still shards); past the last executor rung, the *mode* demotes to the
    sub-volume failsafe (the admission-demotion form, re-resolved at the
    cube geometry). On a CUDA device the executor rungs are
    ``CARD_LADDER``'s, so no rung below a kernel's is a plain forward. The
    caller re-prices admission at the returned key."""
    from repro_torch.core import executors

    dev = engine.device
    ladder = CARD_LADDER if getattr(dev, "type", None) == "cuda" else LADDER
    inner = executors.inner_of(key.executor)
    parsed = executors.parse_sharded(key.executor)
    if inner in ladder and ladder.index(inner) + 1 < len(ladder):
        nxt = ladder[ladder.index(inner) + 1]
        if parsed is not None and executors.shardable(nxt):
            name = executors.ensure_sharded(nxt, parsed[1])
        else:
            name = nxt
        name = executors.resolve(name, engine.cfg.model, key.shape, key.precision, device=dev)
        return dataclasses.replace(key, executor=name)
    if key.mode != "subvolume":
        work = (engine.cfg.cube + 2 * engine.cfg.overlap,) * 3
        name = executors.resolve(
            inner if inner in LADDER else None, engine.cfg.model, work, key.precision, device=dev
        )
        return dataclasses.replace(key, mode="subvolume", executor=name)
    return None  # already at the bottom of the ladder


# --------------------------------------------------------- fault injection ---

FAULT_KINDS = ("transient", "permanent", "straggler", "stuck")

#: cache-tier fault kinds (serving/cache.py). These never fire on the
#: execution path — ``decide`` skips them and ``decide_cache`` sees only
#: them — so adding cache rules to a plan cannot perturb an existing
#: execution-fault storm's coins (byte-stable goldens).
#:
#:   * ``corrupt_entry``      — flip a byte of the stored artifact just
#:     before integrity verification: the checksum mismatch MUST be
#:     caught, quarantined, and transparently recomputed.
#:   * ``cache_unavailable``  — the tier does not answer: the consult
#:     degrades fail-open to the compute path and feeds the cache
#:     breaker.
#:   * ``slow_cache``         — the consult answers after
#:     ``slow_factor``x the modeled verify cost (a slow tier must
#:     degrade latency, never correctness).
CACHE_FAULT_KINDS = ("corrupt_entry", "cache_unavailable", "slow_cache")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule: within virtual-time window
    ``[t0, t1)``, on ``replica`` (None = every replica), for requests
    whose dispatch signature matches the given filters (None = any),
    inject ``kind`` with probability ``rate`` per service attempt.
    ``slow_factor`` scales service time for ``straggler`` rules."""

    kind: str
    rate: float = 1.0
    t0: float = 0.0
    t1: float = math.inf
    replica: Optional[int] = None
    executor_substr: Optional[str] = None
    mode: Optional[str] = None
    shape: Optional[tuple] = None
    precision: Optional[str] = None
    priority: Optional[str] = None
    slow_factor: float = 4.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS + CACHE_FAULT_KINDS:
            raise ResilienceConfigError(
                f"unknown fault kind {self.kind!r}: "
                f"{FAULT_KINDS + CACHE_FAULT_KINDS}"
            )
        if not 0.0 <= self.rate <= 1.0:
            raise ResilienceConfigError(
                f"fault rate must be in [0, 1], got {self.rate}"
            )
        if self.slow_factor < 1.0:
            raise ResilienceConfigError(
                f"slow_factor must be >= 1, got {self.slow_factor}"
            )

    def matches(self, *, t, replica, key, priority) -> bool:
        if not (self.t0 <= t < self.t1):
            return False
        if self.replica is not None and replica != self.replica:
            return False
        if self.priority is not None and priority != self.priority:
            return False
        if key is None:
            # a consult with no dispatch signature (e.g. a fleet-level
            # cache peek): signature filters cannot match it
            return not (
                self.executor_substr is not None
                or self.mode is not None
                or self.shape is not None
                or self.precision is not None
            )
        if (
            self.executor_substr is not None
            and self.executor_substr not in key.executor
        ):
            return False
        if self.mode is not None and key.mode != self.mode:
            return False
        if self.shape is not None and tuple(self.shape) != tuple(key.shape):
            return False
        if self.precision is not None and key.precision != self.precision:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """What the injector decided for one service attempt."""

    kind: str
    rule_index: int
    slow_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, declarative fault schedule. ``decide`` is a PURE
    function of (plan, service-start time, replica, signature, request
    id, attempt): the first rule that matches AND fires (its seeded
    coin, ``unit_hash(seed, rule, replica, request, attempt)``, lands
    under ``rate``) wins. Retried attempts re-roll the coin (the attempt
    index is in the hash), which is exactly what makes retry recovery
    measurable; the time window keys make storms startable/stoppable
    mid-trace. The whole scenario is byte-reproducible from (code,
    seed) — FaultPlans are config, never state."""

    seed: int = 0
    rules: tuple = ()

    def decide(
        self,
        *,
        t: float,
        replica: int,
        key,
        request_id: int,
        attempt: int,
        priority: Optional[str] = None,
    ) -> Optional[FaultDecision]:
        for i, rule in enumerate(self.rules):
            if rule.kind in CACHE_FAULT_KINDS:
                continue  # cache rules never fire on the execution path
            if not rule.matches(t=t, replica=replica, key=key, priority=priority):
                continue
            u = unit_hash("fault", self.seed, i, replica, request_id, attempt)
            if u < rule.rate:
                return FaultDecision(
                    kind=rule.kind,
                    rule_index=i,
                    slow_factor=rule.slow_factor
                    if rule.kind == "straggler"
                    else 1.0,
                )
        return None

    def decide_cache(
        self,
        *,
        t: float,
        replica: int,
        key,
        request_id: int,
        op: str,
    ) -> Optional[FaultDecision]:
        """The cache-tier twin of ``decide``: a PURE function of (plan,
        consult time, replica, signature, request id, op) over the
        CACHE_FAULT_KINDS rules only. ``op`` distinguishes lookups from
        stores in the coin (a request's lookup and its completion's
        store roll independently), with a distinct hash salt so cache
        storms can never collide with execution-fault coins. ``key``
        may be None for consults with no dispatch signature."""
        for i, rule in enumerate(self.rules):
            if rule.kind not in CACHE_FAULT_KINDS:
                continue  # execution rules never fire on the cache path
            if not rule.matches(t=t, replica=replica, key=key, priority=None):
                continue
            u = unit_hash("cachefault", self.seed, i, replica, request_id, op)
            if u < rule.rate:
                return FaultDecision(
                    kind=rule.kind,
                    rule_index=i,
                    slow_factor=rule.slow_factor
                    if rule.kind == "slow_cache"
                    else 1.0,
                )
        return None

    def has_stuck(self) -> bool:
        return any(r.kind == "stuck" for r in self.rules)

    def has_cache_rules(self) -> bool:
        return any(r.kind in CACHE_FAULT_KINDS for r in self.rules)


# ----------------------------------------------------------- policy bundle ---


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """The full resilience configuration one scheduler (and, via
    ``FleetConfig.resilience``, every replica plus the fleet's hedging
    loop) runs under. ``service_timeout_s`` maps priority-class name ->
    per-attempt service bound (classes absent from the map never time
    out); ``hedge=None`` disables hedging; ``breaker=None`` disables the
    degradation ladder."""

    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    service_timeout_s: dict = dataclasses.field(default_factory=dict)
    hedge: Optional[HedgePolicy] = None
    breaker: Optional[BreakerConfig] = dataclasses.field(
        default_factory=BreakerConfig
    )

    def timeout_for(self, priority_class: str) -> Optional[float]:
        return self.service_timeout_s.get(priority_class)

    def validate_against(self, classes: dict, fault_plan) -> None:
        """Reject configurations that cannot terminate: a FaultPlan with
        stuck-forever rules requires EVERY priority class to carry a
        service timeout, or a stuck request would occupy its replica
        until the end of time (typed ``ResilienceConfigError`` — the
        serving analogue of scale-to-zero being an outage)."""
        if fault_plan is None or not fault_plan.has_stuck():
            return
        missing = [
            name for name in classes if self.timeout_for(name) is None
        ]
        if missing:
            raise ResilienceConfigError(
                "FaultPlan injects stuck-forever faults but classes "
                f"{missing} have no service timeout; a stuck request "
                "would never be cancelled"
            )
