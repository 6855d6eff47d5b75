"""Fleet-scale serving: replicated schedulers behind a cache-affinity
router — counterpart of ``repro/serving/fleet.py``.

One scheduler can only go deeper (a longer queue) under overload; the
fleet goes wider:

  * **Replicas** — N independent ``RequestScheduler``s, each owning its
    own ``SegmentationEngine`` and so its own prepared weights
    (``SegmentationEngine._prepared``), built by ``engine_factory``. On a
    card the replicas share the device and nothing else: no prepared
    weights across engines, and no segmentation tensor across
    completions (the scheduler's ``_own_copy``). Their shared state is
    the virtual clock and, when configured, one ``ArtifactCache``.
  * **Router** — pluggable policies over the routable (live,
    non-draining) replica set: ``round_robin``, ``least_loaded`` (least
    priced backlog bytes), ``join_shortest_queue``, and ``cache_affinity``
    — the scheduler's dispatch signature (``GroupKey``: mode, executor,
    devices, precision, shape) is the affinity key, and requests are
    steered to replicas that already dispatched that signature, i.e. are
    warm for it (built kernels, prepared weights, allocator pools). A cold
    signature costs ``FleetServiceModel.cold_compile_s`` once per
    (replica, signature), so affinity shows in the latencies.
  * **Failure and drain with exactly-once re-dispatch** — a crashed
    replica's queued requests and the un-served tail of its in-flight
    batch (``RequestScheduler.run_batch_until`` never executes members
    that would finish past the crash) are re-routed to surviving
    replicas; the fleet ledger maps every fleet request id to exactly one
    terminal completion. Draining is the graceful version: no new routes,
    the backlog is re-dispatched (or self-served when no peer exists),
    the in-flight batch finishes, then the replica retires.
  * **Autoscaler** — at a fixed virtual interval, SLO attainment of the
    guarded class over the last window decides scale-up; a clean window
    plus empty queues decides scale-down (drain the youngest replica),
    within [min_replicas, max_replicas] and a cooldown. ``min_replicas >=
    1`` is enforced with a typed ``FleetConfigError``.
  * **Hedging** — with ``ResiliencePolicy.hedge`` set, a queued request
    older than a p99-derived threshold gets a second copy on another
    replica; the first served completion wins and the ledger cancels the
    loser.

Everything runs on one ``VirtualClock``, so fleet percentiles, shed
counts, affinity hit rates and the autoscaler's timeline are functions of
(code, seed) alone: ``simulate_fleet`` summaries are byte-exact goldens
(``tests/golden/torch_fleet_*.json``, ``tools/write_serving_goldens.py``).

**Executed fleets** (``FleetConfig.execute=True``) run each request
through its replica's engine, on the card by default. Service is still
priced on the virtual clock from the executed record
(``ServiceModel.service_s``), so an executed run decides as the modeled
run does. A ``FleetEvent`` crash cannot run there: ``_dispatch_idle``
serves a batch on a replica with a pending crash through
``run_batch_until(batch, crash_t)``, and a finite horizon raises on the
executed path (it must predict each member's duration before running
it), as in the reference. Drive failover on an executed fleet with
``crash_replica`` and ``drain_replica`` between dispatches instead.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.serving import cache as cache_mod
from repro_torch.serving.errors import (  # noqa: F401  (re-exported names)
    FleetConfigError,
    NoReplicaAvailable,
    QueueFullError,
)
from repro_torch.serving.scheduler import (
    RequestScheduler,
    SchedulerConfig,
    ServeRequest,
)
from repro_torch.serving.simulator import (
    ARRIVAL_PROCESSES,
    SERVED,
    ServiceModel,
    VirtualClock,
    _make_volume,
    _pctls_ms,
    _round,
    _sample_mix,
    _ShapeStub,
    reference_engine,
    zipf_content_id,
)
from repro_torch.telemetry.analysis import nearest_rank

#: router policies (see Fleet._pick); cache_affinity is the presets'
#: default, the one that uses the dispatch signatures
ROUTER_POLICIES = (
    "round_robin",
    "least_loaded",
    "join_shortest_queue",
    "cache_affinity",
)


@dataclasses.dataclass(frozen=True)
class FleetServiceModel(ServiceModel):
    """``ServiceModel`` (an H100's bandwidths) plus the fleet-visible
    first-use cost: the first batch of a dispatch signature on a replica
    stalls ``cold_compile_s`` virtual seconds; later batches of that
    signature there are warm. With N replicas and round-robin, every
    signature pays it about N times. The 0.25 s default is the
    reference's scenario cost, not a measurement of the card."""

    cold_compile_s: float = 0.25


@dataclasses.dataclass
class AutoscalerConfig:
    """The control law: every ``interval_s`` virtual seconds, look at the
    guarded class's completions in the last window.

      attainment = fraction served end to end within ``slo_latency_s``
                   (shed or refused requests in the window are misses)

      attainment < up_attainment  and replicas < max  -> add a replica
      attainment >= down_attainment (or an idle window) and every queue
      empty and replicas > min -> drain the youngest replica

    ``cooldown_s`` rate-limits actions. ``min_replicas`` must be >= 1:
    scale-to-zero is rejected with a typed ``FleetConfigError`` at fleet
    construction."""

    interval_s: float = 60.0
    min_replicas: int = 1
    max_replicas: int = 8
    slo_class: str = "interactive"
    slo_latency_s: float = 2.0
    up_attainment: float = 0.9
    down_attainment: float = 0.98
    cooldown_s: float = 120.0


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One planned operator or fault action: ``crash`` (kill mid-batch,
    evacuate and re-dispatch; modeled fleets only), ``drain`` (graceful
    removal) or ``add`` (a planned capacity bump)."""

    t: float
    action: str  # crash | drain | add
    replica: Optional[int] = None  # target id for crash/drain


@dataclasses.dataclass
class FleetConfig:
    """One fleet simulation: seeded arrivals over a scenario mix, routed
    across ``replicas`` schedulers (each configured by ``scheduler``),
    with an optional fault plan (``events``) and autoscaler.

    ``resilience`` and ``fault_plan`` apply to every replica's scheduler
    (keyed by its replica id, so injection decisions and backoff jitter
    differ per replica); the fleet also runs the hedging loop when
    ``resilience.hedge`` is set. ``cache`` (a ``CacheConfig``, or an
    ``ArtifactCache``) builds one cache shared by every replica.
    ``content_skew`` gives the modeled volumes Zipf content identities.
    All None keeps a scenario's summary, and its golden, as without
    them."""

    name: str = "fleet"
    seed: int = 0
    horizon_s: float = 600.0
    process: str = "poisson"
    process_kwargs: dict = dataclasses.field(default_factory=lambda: {"rate_hz": 2.0})
    mix: tuple = ()
    replicas: int = 2
    policy: str = "cache_affinity"
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    service: FleetServiceModel = dataclasses.field(default_factory=FleetServiceModel)
    autoscaler: Optional[AutoscalerConfig] = None
    events: tuple = ()
    execute: bool = False
    resilience: Optional[object] = None
    fault_plan: Optional[object] = None
    cache: Optional[object] = None
    content_skew: Optional[float] = None
    content_universe: int = 64


@dataclasses.dataclass
class FleetRequest:
    """Fleet-ledger entry: one row per arriving request, whatever happens
    to it. ``dispatches`` > 1 means failover moved it; ``completions_seen``
    must end at <= 1 (a request served twice would count twice)."""

    fid: int
    arrival_s: float
    priority: str
    replica: Optional[int] = None  # current/last owner
    dispatches: int = 0
    outcome: Optional[str] = None  # completed|demoted|coalesced|rejected|refused|no_replica
    finish_s: Optional[float] = None
    completion: Optional[object] = None
    completions_seen: int = 0
    # live copies of this request across the fleet: (replica id, local
    # request id) -> is_hedge. Normally one; a hedge adds a second, and
    # the first served completion cancels the rest through the ledger
    copies: dict = dataclasses.field(default_factory=dict)
    hedges: int = 0  # hedge copies ever granted to this request


class Replica:
    """One fleet member: an engine (its own prepared weights) behind its
    own ``RequestScheduler``, plus the fleet-side state the router and the
    event loop need: busy horizon, warm signatures, drain and crash
    flags."""

    def __init__(self, rid: int, engine, fleet: "Fleet"):
        self.id = rid
        self.engine = engine
        self.sched = RequestScheduler(
            engine,
            fleet.cfg.scheduler,
            clock=fleet.clock,
            service_model=fleet.cfg.service,
            execute=fleet.cfg.execute,
            resilience=fleet.cfg.resilience,
            fault_plan=fleet.cfg.fault_plan,
            replica_id=rid,
            cache=fleet.cache,  # the shared tier: one instance fleetwide
        )
        self.busy_until = fleet.clock.now()
        self.inflight = False
        self.inflight_unserved: list[ServeRequest] = []
        self.warm: set = set()  # dispatch signatures this replica has run
        self.draining = False
        self.crashed = False
        self.retired = False
        self.created_s = fleet.clock.now()
        self._synced = 0  # completions already folded into the fleet ledger

    @property
    def live(self) -> bool:
        return not (self.crashed or self.retired)

    @property
    def routable(self) -> bool:
        return self.live and not self.draining

    def queue_len(self) -> int:
        return len(self.sched.queue)

    def backlog_bytes(self) -> int:
        return sum(r.bytes_priced for r in self.sched.queue)


class Fleet:
    """N replica schedulers behind a policy router on one virtual clock.

    Drive it through ``simulate_fleet`` (seeded traffic, the golden path)
    or directly: ``submit`` routes one request (raising typed
    ``NoReplicaAvailable`` / ``QueueFullError`` backpressure), ``drain``
    serves everything queued, ``scale_up``/``scale_down`` and
    ``crash_replica``/``drain_replica`` are the operator verbs the event
    plan and the autoscaler use.

    ``engine_factory()`` builds each replica's engine; without one the
    replicas are ``simulator.reference_engine()``, on the card (it raises
    on a host without one)."""

    def __init__(self, cfg: FleetConfig, engine_factory: Optional[Callable] = None):
        if cfg.replicas < 1:
            raise FleetConfigError(
                f"fleet needs >= 1 replica, got {cfg.replicas} (scale-to-zero is an outage, not a configuration)"
            )
        if cfg.policy not in ROUTER_POLICIES:
            raise FleetConfigError(f"unknown router policy {cfg.policy!r}: {ROUTER_POLICIES}")
        if cfg.autoscaler is not None and cfg.autoscaler.min_replicas < 1:
            raise FleetConfigError(
                f"autoscaler scale-to-zero rejected: min_replicas must be >= 1, got {cfg.autoscaler.min_replicas}"
            )
        self.cfg = cfg
        self.engine_factory = engine_factory or reference_engine
        self.clock = VirtualClock()
        # the shared artifact-cache tier: one instance in front of every
        # replica, so content-identical requests hit the same entries
        # whichever replica serves them, and the router can steer a
        # request to its in-flight single-flight leader
        self.cache = None
        self.content_routes = 0  # routes steered to an in-flight leader
        if cfg.cache is not None:
            self.cache = (
                cfg.cache
                if isinstance(cfg.cache, cache_mod.ArtifactCache)
                else cache_mod.ArtifactCache(
                    cfg.cache if isinstance(cfg.cache, cache_mod.CacheConfig) else None, fault_plan=cfg.fault_plan
                )
            )
        self.replicas: list[Replica] = []  # every replica ever created
        self.ledger: list[FleetRequest] = []
        self._fid: dict[tuple[int, int], int] = {}  # (replica, local id) -> fid
        self._next_id = 0
        self._rr = 0
        self.refused = 0  # queue-full at the routed replica
        self.no_replica = 0  # typed router backpressure
        self.redispatched = 0
        self.routes = 0
        self.affinity_hits = 0
        self.cold_compiles = 0
        # hedging: accepted hedge submissions, races won by the hedge
        # copy, loser copies cancelled out of queues by the ledger; the
        # window of served end-to-end seconds (newest last) feeds the
        # p99-derived hedge threshold
        self._hedge = getattr(cfg.resilience, "hedge", None)
        self.hedges = 0
        self.hedge_wins = 0
        self.hedge_cancelled = 0
        self._lat: list[float] = []
        self.scale_log: list[dict] = []
        self.peak_routable = 0
        self._last_scale_s = -math.inf
        self._events: list[FleetEvent] = sorted(
            cfg.events, key=lambda e: (e.t, e.action, -1 if e.replica is None else e.replica)
        )
        self._ei = 0
        for _ in range(cfg.replicas):
            self._add_replica(0.0, log=False)

    # ------------------------------------------------------------- replicas

    def _routable(self) -> list[Replica]:
        return [r for r in self.replicas if r.routable]

    def _by_id(self, rid) -> Optional[Replica]:
        for r in self.replicas:
            if r.id == rid:
                return r
        return None

    def _add_replica(self, now: float, log: bool = True, action: str = "add") -> Replica:
        rid = self._next_id
        self._next_id += 1
        rep = Replica(rid, self.engine_factory(), self)
        rep.busy_until = now
        rep.created_s = now
        self.replicas.append(rep)
        self.peak_routable = max(self.peak_routable, len(self._routable()))
        if log:
            self._log_scale(now, action, rid)
        return rep

    def _log_scale(self, now: float, action: str, rid: int) -> None:
        self.scale_log.append(
            {"t": _round(now), "action": action, "replica": rid, "replicas_after": len(self._routable())}
        )

    def scale_up(self, now: Optional[float] = None) -> Replica:
        """Add one replica (a fresh engine: nothing warm)."""
        return self._add_replica(self.clock.now() if now is None else now)

    def scale_down(self, now: Optional[float] = None) -> Replica:
        """Drain the youngest routable replica. Raises a typed
        ``FleetConfigError`` when that would leave no routable replica."""
        now = self.clock.now() if now is None else now
        routable = self._routable()
        if len(routable) <= 1:
            raise FleetConfigError("scale-to-zero rejected: draining the last routable replica would black-hole all traffic")
        victim = max(routable, key=lambda r: r.id)
        self.drain_replica(victim.id, now)
        return victim

    def drain_replica(self, rid: int, now: Optional[float] = None) -> None:
        """Graceful removal: stop routing to the replica, re-dispatch its
        queued backlog to peers (exactly once: each request keeps its
        fleet id and original arrival), let its in-flight batch finish,
        then retire it. With no routable peer left, the backlog stays and
        the draining replica serves it out itself."""
        now = self.clock.now() if now is None else now
        rep = self._by_id(rid)
        if rep is None or not rep.live or rep.draining:
            return
        rep.draining = True
        self._log_scale(now, "drain", rep.id)
        if any(r.routable for r in self.replicas):
            self._redispatch(rep.sched.evacuate(now), now, rep)
        # else: keep the queue; _dispatch_idle still serves draining
        # replicas' own backlogs, so a sole drained replica self-drains

    def crash_replica(self, rid: int, now: Optional[float] = None) -> None:
        """Hard failure: the replica dies now. Members of its in-flight
        batch that had not finished (``run_batch_until`` never executed
        them) and its whole queue are re-dispatched to surviving replicas,
        exactly once each. Raises ``NoReplicaAvailable`` if no survivor
        exists to take them."""
        now = self.clock.now() if now is None else now
        rep = self._by_id(rid)
        if rep is None or not rep.live:
            return
        unserved = rep.inflight_unserved
        rep.inflight_unserved = []
        rep.inflight = False
        rep.crashed = True
        rep.busy_until = now
        # in-flight members handed back: admitted there, served elsewhere
        rep.sched.stats.evacuated += len(unserved)
        evac = unserved + rep.sched.evacuate(now)
        self._log_scale(now, "crash", rep.id)
        if evac:
            self._redispatch(evac, now, rep)

    # --------------------------------------------------------------- router

    def _load_jsq(self, r: Replica) -> tuple:
        return (r.queue_len() + (1 if r.inflight else 0), r.id)

    def _pick(self, vol, mode, executor, devices, precision, exclude: Optional[Replica] = None) -> Replica:
        """One routing decision under the configured policy. Only live,
        non-draining replicas are candidates: cache affinity never routes
        to a draining replica, however warm it is."""
        cands = sorted((r for r in self._routable() if r is not exclude), key=lambda r: r.id)
        if not cands:
            raise NoReplicaAvailable(
                total=len(self.replicas),
                draining=sum(1 for r in self.replicas if r.live and r.draining),
                crashed=sum(1 for r in self.replicas if r.crashed),
            )
        self.routes += 1
        if self.cache is not None:
            # content-to-leader steering, in front of every policy: a
            # request whose artifact is being computed in flight routes to
            # the leader's replica, where the scheduler attaches it as a
            # single-flight follower; a miss (or an unroutable owner)
            # falls through to the configured policy
            ckey = self._content_key(vol, mode, executor, devices, precision, cands[0])
            if ckey is not None:
                owner = self.cache.inflight_owner(ckey)
                if owner is not None:
                    rep = self._by_id(owner)
                    if rep is not None and rep in cands:
                        self.content_routes += 1
                        return rep
        policy = self.cfg.policy
        if policy == "round_robin":
            chosen = cands[self._rr % len(cands)]
            self._rr += 1
        elif policy == "least_loaded":
            chosen = min(cands, key=lambda r: (r.backlog_bytes(), r.queue_len(), r.id))
        elif policy == "join_shortest_queue":
            chosen = min(cands, key=self._load_jsq)
        else:  # cache_affinity
            key, _ = cands[0].sched.peek_signature(
                vol, mode=mode, executor=executor, devices=devices, precision=precision
            )
            warm = [r for r in cands if key is not None and key in r.warm]
            if warm:
                self.affinity_hits += 1
                chosen = min(warm, key=self._load_jsq)
            else:
                chosen = min(cands, key=self._load_jsq)
        assert not chosen.draining and chosen.live
        return chosen

    def _content_key(self, vol, mode, executor, devices, precision, ref: Replica) -> Optional[str]:
        """The artifact key a request would cache under, resolved through
        ``ref``'s signature cache (every replica serves the same model, so
        any replica's resolution holds). None when the volume has no
        content identity: uncacheable, routed by policy."""
        content = cache_mod.content_hash(vol)
        if content is None:
            return None
        key, _ = ref.sched.peek_signature(vol, mode=mode, executor=executor, devices=devices, precision=precision)
        if key is None:
            return None
        if ref.sched._model_fp is None:
            ref.sched._model_fp = cache_mod.model_fingerprint(ref.sched.engine.cfg.model)
        return cache_mod.artifact_key(content, ref.sched._model_fp, key.precision, key.mode)

    def submit(
        self,
        vol,
        *,
        priority: str = "standard",
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        devices: Optional[int] = None,
        precision: Optional[str] = None,
        arrival_s: Optional[float] = None,
    ) -> int:
        """Route one request; returns its fleet id (stable across failover
        re-dispatch). Raises typed ``NoReplicaAvailable`` (no routable
        replica) or ``QueueFullError`` (the routed replica's queue is at
        depth); both are counted and ledgered as terminal refusals, so the
        fleet conservation sum still covers them."""
        now = self.clock.now() if arrival_s is None else float(arrival_s)
        fid = len(self.ledger)
        entry = FleetRequest(fid=fid, arrival_s=now, priority=priority)
        self.ledger.append(entry)
        try:
            target = self._pick(vol, mode, executor, devices, precision)
        except NoReplicaAvailable:
            entry.outcome = "no_replica"
            self.no_replica += 1
            raise
        try:
            lid = target.sched.submit(
                vol,
                priority=priority,
                mode=mode,
                executor=executor,
                devices=devices,
                precision=precision,
                arrival_s=now,
            )
        except QueueFullError:
            entry.outcome = "refused"
            self.refused += 1
            raise
        self._fid[(target.id, lid)] = fid
        entry.replica = target.id
        entry.dispatches = 1
        entry.copies[(target.id, lid)] = False
        return fid

    def _redispatch(self, reqs: list, now: float, source: Replica) -> None:
        """Exactly-once failover: each evacuated request keeps its fleet id
        and original arrival time, and is force-admitted at its new
        replica (depth limits must not turn an admitted request into a
        lost one). A copy whose entry was already served (its hedge twin
        won) or that still has a live twin elsewhere is dropped."""
        for req in sorted(reqs, key=lambda r: (r.arrival_s, r.id)):
            fid = self._fid.pop((source.id, req.id))
            entry = self.ledger[fid]
            was_hedge = entry.copies.pop((source.id, req.id), False)
            if entry.outcome in SERVED or entry.copies:
                self.hedge_cancelled += 1
                continue
            target = self._pick(req.vol, req.mode, req.executor, req.devices, req.precision, exclude=source)
            lid = target.sched.submit(
                req.vol,
                priority=req.priority_class.name,
                mode=req.mode,
                executor=req.executor,
                devices=req.devices,
                precision=req.precision,
                arrival_s=req.arrival_s,
                force=True,
            )
            self._fid[(target.id, lid)] = fid
            entry.replica = target.id
            entry.dispatches += 1
            entry.copies[(target.id, lid)] = was_hedge
            self.redispatched += 1

    # ----------------------------------------------------------- event loop

    def _sync(self, rep: Replica) -> None:
        """Fold the replica's new completions into the fleet ledger and
        stamp their telemetry with the replica id. With hedging, a fleet
        request can hold several live copies; the first served completion
        wins the entry and cancels the twins, and a loser that was merely
        evacuated must not overwrite the winner's outcome.
        ``completions_seen`` counts served completions only: the
        double-serve detector."""
        comps = rep.sched.completions
        for c in comps[rep._synced:]:
            c.record.replica_id = rep.id
            fid = self._fid.get((rep.id, c.id))
            if fid is None:
                continue
            entry = self.ledger[fid]
            was_hedge = entry.copies.pop((rep.id, c.id), False)
            served = c.outcome in SERVED
            if entry.outcome in SERVED and not served:
                continue  # losing copy shed after its twin won
            entry.outcome = c.outcome
            entry.finish_s = c.finish_s
            entry.completion = c
            if served:
                entry.completions_seen += 1
                if was_hedge:
                    self.hedge_wins += 1
                self._observe_latency(c.finish_s - entry.arrival_s)
                self._cancel_copies(entry)
        rep._synced = len(comps)

    # ------------------------------------------------------------- hedging

    def _observe_latency(self, e2e_s: float) -> None:
        if self._hedge is None:
            return
        self._lat.append(e2e_s)
        if len(self._lat) > self._hedge.window:
            del self._lat[: len(self._lat) - self._hedge.window]

    def _cancel_copies(self, entry: FleetRequest) -> None:
        """Cancel every still-queued copy of a fleet request whose twin
        just won: the scheduler counts the removal as an evacuation, so
        each replica's own conservation ledger stays balanced."""
        for (rid, lid) in list(entry.copies):
            rep = self._by_id(rid)
            if rep is None or not rep.live:
                continue
            if rep.sched.cancel(lid) is not None:
                self._fid.pop((rid, lid), None)
                entry.copies.pop((rid, lid), None)
                self.hedge_cancelled += 1

    def _hedge_threshold(self) -> Optional[float]:
        h = self._hedge
        if h is None or len(self._lat) < h.min_samples:
            return None
        return max(h.min_age_s, h.p99_factor * nearest_rank(self._lat, 99))

    def _maybe_hedge(self, now: float) -> None:
        """Tail-latency hedging: when a queued request's age crosses the
        p99-derived threshold, dispatch a second copy to the least-loaded
        replica not already holding one. The first served completion
        wins; the loser is cancelled through the ledger. Hedge copies are
        speculative, not failover, so they are not counted as
        re-dispatches."""
        thr = self._hedge_threshold()
        if thr is None:
            return
        for rep in sorted(self.replicas, key=lambda r: r.id):
            if not rep.live:
                continue
            for req in list(rep.sched.queue):
                if req.key is None:
                    continue
                fid = self._fid.get((rep.id, req.id))
                if fid is None:
                    continue
                entry = self.ledger[fid]
                if now - entry.arrival_s < thr or entry.hedges >= self._hedge.max_hedges or entry.outcome is not None:
                    continue
                holders = {rid for (rid, _lid) in entry.copies}
                cands = [r for r in self._routable() if r.id not in holders]
                if not cands:
                    continue
                target = min(cands, key=self._load_jsq)
                try:
                    lid = target.sched.submit(
                        req.vol,
                        priority=req.priority_class.name,
                        mode=req.mode,
                        executor=req.executor,
                        devices=req.devices,
                        precision=req.precision,
                        arrival_s=entry.arrival_s,
                    )
                except QueueFullError:
                    continue
                self._fid[(target.id, lid)] = fid
                entry.copies[(target.id, lid)] = True
                entry.hedges += 1
                self.hedges += 1

    def _next_crash_t(self, rep: Replica) -> Optional[float]:
        for ev in self._events[self._ei:]:
            if ev.action == "crash" and ev.replica == rep.id:
                return ev.t
        return None

    def _dispatch_idle(self, now: float) -> bool:
        """Form and launch one batch on every idle replica that has queued
        work (draining replicas included: their queue is non-empty only
        when no peer could absorb it). Returns whether anything
        progressed. A batch on a replica with a scheduled crash is served
        only up to the crash instant (``run_batch_until``, modeled fleets
        only); the un-served tail waits there for the crash to evacuate
        it."""
        progressed = False
        for rep in sorted(self.replicas, key=lambda r: r.id):
            if not rep.live or rep.inflight or rep.busy_until > now:
                continue
            if not rep.sched.queue:
                continue
            batch = rep.sched.next_batch(now=now)
            if batch is None:
                # everything queued just expired (typed rejects: new
                # completions) or the whole queue waits on retry backoff
                # (no progress now; the run loop sleeps to next_ready_s)
                before = rep._synced
                self._sync(rep)
                if rep._synced != before:
                    progressed = True
                continue
            key = batch.requests[0].key
            start = now
            if key is not None and key not in rep.warm:
                # the first batch of this signature on this replica
                start += self.cfg.service.cold_compile_s
                self.cold_compiles += 1
                rep.warm.add(key)
            crash_t = self._next_crash_t(rep)
            t_end, unserved = rep.sched.run_batch_until(batch, crash_t, now=start)
            self._sync(rep)
            rep.inflight = True
            if unserved:
                rep.inflight_unserved = unserved
                rep.busy_until = crash_t  # dies mid-batch
            else:
                rep.busy_until = t_end
            progressed = True
        return progressed

    def _autoscale(self, t: float) -> None:
        a = self.cfg.autoscaler
        window = []
        for entry in self.ledger:
            if entry.priority != a.slo_class or entry.outcome is None:
                continue
            fin = entry.finish_s if entry.finish_s is not None else entry.arrival_s
            if t - a.interval_s < fin <= t:
                window.append(entry)
        if window:
            met = sum(
                1 for e in window if e.outcome in SERVED and (e.finish_s - e.arrival_s) <= a.slo_latency_s
            )
            attainment = met / len(window)
        else:
            attainment = None  # idle window: no SLO pressure either way
        routable = self._routable()
        if t - self._last_scale_s < a.cooldown_s:
            return
        if attainment is not None and attainment < a.up_attainment and len(routable) < a.max_replicas:
            self._add_replica(t)
            self._last_scale_s = t
        elif (
            (attainment is None or attainment >= a.down_attainment)
            and sum(r.queue_len() for r in routable) == 0
            and len(routable) > a.min_replicas
        ):
            self.scale_down(t)
            self._last_scale_s = t

    def run(self, arrivals: list, vols: list) -> None:
        """The multi-server discrete-event loop: deliver arrivals through
        the router, serve batches on every idle replica in parallel
        virtual time, fire the event plan and autoscaler ticks, retire
        drained replicas, until the trace and every queue are empty. The
        loop starts at the clock's time, so a later ``drain`` serves what
        was submitted after an earlier one (the reference starts at 0.0,
        and its second ``drain`` leaves the queue: ROADMAP.md, Queue 3,
        R7)."""
        cfg = self.cfg
        auto = cfg.autoscaler
        next_tick = auto.interval_s if auto else math.inf
        i, n = 0, len(arrivals)
        now = self.clock.now()
        while True:
            # retire drained replicas that finished their backlog
            for rep in self.replicas:
                if rep.live and rep.draining and not rep.inflight and not rep.sched.queue and rep.busy_until <= now:
                    rep.retired = True
            self._maybe_hedge(now)
            if self._dispatch_idle(now):
                continue
            cand = []
            if i < n:
                cand.append(arrivals[i][0])
            for rep in self.replicas:
                if rep.live and rep.inflight:
                    cand.append(rep.busy_until)
                elif rep.live and rep.sched.queue:
                    # a queue gated behind retry backoff wakes when the
                    # earliest not_before_s elapses
                    wake = rep.sched.next_ready_s(now)
                    if wake is not None:
                        cand.append(wake)
            if self._ei < len(self._events):
                cand.append(self._events[self._ei].t)
            if auto and next_tick <= cfg.horizon_s:
                cand.append(next_tick)
            if not cand:
                break
            now = max(now, min(cand))
            self.clock.advance_to(now)
            for rep in self.replicas:
                if rep.live and rep.inflight and rep.busy_until <= now:
                    rep.inflight = False
            while self._ei < len(self._events) and self._events[self._ei].t <= now:
                ev = self._events[self._ei]
                self._ei += 1
                if ev.action == "add":
                    self._add_replica(now)
                elif ev.action == "crash":
                    self.crash_replica(ev.replica, now)
                elif ev.action == "drain":
                    self.drain_replica(ev.replica, now)
                else:
                    raise FleetConfigError(f"unknown fleet event {ev.action!r}")
            while auto and next_tick <= now:
                self._autoscale(next_tick)
                next_tick += auto.interval_s
            while i < n and arrivals[i][0] <= now:
                t, spec = arrivals[i]
                try:
                    self.submit(
                        vols[i],
                        priority=spec.priority,
                        mode=spec.mode,
                        executor=spec.executor,
                        devices=spec.devices,
                        precision=spec.precision,
                        arrival_s=t,
                    )
                except (QueueFullError, NoReplicaAvailable):
                    pass  # counted and ledgered as typed terminal refusals
                i += 1
        for rep in self.replicas:
            self._sync(rep)
            assert rep.sched.stats.conserved(), f"replica {rep.id} conservation violated: {rep.sched.stats}"

    def drain(self) -> None:
        """Serve everything queued (no new arrivals): the direct-API
        counterpart of ``RequestScheduler.drain``."""
        self.run([], [])

    # -------------------------------------------------------------- rollups

    def conserved(self) -> bool:
        """The fleet-wide conservation law: every arrival has exactly one
        terminal outcome, per-replica ledgers balance (evacuations
        included), and nothing was served twice."""
        if any(e.outcome is None for e in self.ledger):
            return False
        if any(e.completions_seen > 1 for e in self.ledger):
            return False
        return all(r.sched.stats.conserved() for r in self.replicas)


@dataclasses.dataclass
class FleetReport:
    cfg: FleetConfig
    fleet: Fleet
    arrived: int

    def summary(self) -> dict:
        """The deterministic fleet rollup, the golden-trace payload:
        counts and conservation (fleet and per replica), fleet-wide and
        per-class virtual-latency percentiles over original arrival times
        (failover latency includes the time lost to the dead replica),
        router and affinity counters, and the autoscaler and fault
        timeline."""
        fl = self.fleet
        entries = fl.ledger
        served = [e for e in entries if e.outcome in SERVED]
        rejected: dict[str, int] = {}
        for rep in fl.replicas:
            for reason, cnt in rep.sched.stats.rejected.items():
                rejected[reason] = rejected.get(reason, 0) + cnt
        classes: dict[str, dict] = {}
        by_class: dict[str, list[FleetRequest]] = {}
        for e in entries:
            by_class.setdefault(e.priority, []).append(e)
        for name in sorted(by_class):
            es = by_class[name]
            sv = [e for e in es if e.outcome in SERVED]
            classes[name] = {
                "requests": len(es),
                "served": len(sv),
                "demoted": sum(1 for e in es if e.outcome == "demoted"),
                "rejected": sum(1 for e in es if e.outcome == "rejected"),
                "refused": sum(1 for e in es if e.outcome in ("refused", "no_replica")),
                "redispatched": sum(1 for e in sv if e.dispatches > 1),
                "latency_ms": _pctls_ms([e.finish_s - e.arrival_s for e in sv]),
                "queue_wait_ms": _pctls_ms([e.completion.record.queue_wait_s or 0.0 for e in sv]),
            }
        per_replica = []
        for rep in sorted(fl.replicas, key=lambda r: r.id):
            st = rep.sched.stats
            row = {
                "id": rep.id,
                "admitted": st.admitted,
                "completed": st.completed,
                "demoted": st.demoted,
                "rejected": st.rejected_total(),
                "evacuated": st.evacuated,
                "refused": st.refused,
                "batches": st.batches,
                "max_queue_depth": st.max_queue_depth,
                "warm_signatures": len(rep.warm),
                "crashed": rep.crashed,
                "drained": rep.retired,
            }
            if fl.cache is not None:
                # the fifth terminal state, stamped on cached runs only
                row["coalesced"] = st.coalesced
                row["cache_hits"] = st.cache_hits
            per_replica.append(row)
        total_batches = sum(r.sched.stats.batches for r in fl.replicas)
        out = {
            "scenario": self.cfg.name,
            "seed": self.cfg.seed,
            "horizon_s": _round(self.cfg.horizon_s),
            "process": self.cfg.process,
            "policy": self.cfg.policy,
            "requests": {
                "arrived": self.arrived,
                "refused": fl.refused,
                "no_replica": fl.no_replica,
                "admitted": sum(r.sched.stats.admitted for r in fl.replicas),
                "completed": sum(1 for e in entries if e.outcome == "completed"),
                "demoted": sum(1 for e in entries if e.outcome == "demoted"),
                "rejected": dict(sorted(rejected.items())),
                "evacuated": sum(r.sched.stats.evacuated for r in fl.replicas),
                "redispatched": fl.redispatched,
                "served_twice": sum(1 for e in entries if e.completions_seen > 1),
                "conserved": fl.conserved(),
            },
            "batches": total_batches,
            "mean_batch_size": _round(len(served) / max(total_batches, 1)),
            "max_queue_depth": max((r.sched.stats.max_queue_depth for r in fl.replicas), default=0),
            "throughput_rps": _round(len(served) / self.cfg.horizon_s),
            "latency_ms": _pctls_ms([e.finish_s - e.arrival_s for e in served]),
            "classes": classes,
            "affinity": {
                "policy": self.cfg.policy,
                "routes": fl.routes,
                "warm_hits": fl.affinity_hits,
                "hit_rate": _round(fl.affinity_hits / max(fl.routes, 1)),
                "cold_compiles": fl.cold_compiles,
            },
            "replicas": {
                "initial": self.cfg.replicas,
                "created": len(fl.replicas),
                "peak_routable": fl.peak_routable,
                "final_routable": len(fl._routable()),
                "crashed": sum(1 for r in fl.replicas if r.crashed),
                "drained": sum(1 for r in fl.replicas if r.retired),
            },
            "scale_events": fl.scale_log,
            "per_replica": per_replica,
        }
        # each block only when its layer is configured, so the scenarios
        # without it keep their summaries byte for byte
        if self.cfg.resilience is not None or self.cfg.fault_plan is not None:
            out["resilience"] = self._resilience_block(served)
        if self.cfg.cache is not None:
            out["cache"] = self._cache_block(served)
        return out

    def _cache_block(self, served: list) -> dict:
        """The fleet-wide artifact-cache rollup: the shared tier's own
        counters plus the replicas' terminal cache accounting summed —
        admission hits, coalesced completions, requests served without a
        forward, and router steers to in-flight leaders.
        ``quarantined_served`` must stay 0."""
        fl = self.fleet
        out = dict(fl.cache.summary())
        out["admission_hits"] = sum(r.sched.stats.cache_hits for r in fl.replicas)
        out["coalesced"] = sum(r.sched.stats.coalesced for r in fl.replicas)
        out["served_from_cache"] = sum(
            1 for e in served if e.completion is not None and e.completion.record.cache_hit
        )
        out["content_routes"] = fl.content_routes
        return out

    def _resilience_block(self, served: list) -> dict:
        fl = self.fleet
        stats = [rep.sched.stats for rep in fl.replicas]
        faulted = sum(s.faulted_requests for s in stats)
        recovered = sum(s.recovered_requests for s in stats)
        block: dict = {
            "retries": sum(s.retries for s in stats),
            "faults": {
                "transient": sum(s.transient_faults for s in stats),
                "permanent": sum(s.permanent_faults for s in stats),
                "timeout": sum(s.timeouts for s in stats),
            },
            "faulted_requests": faulted,
            "recovered_requests": recovered,
            "recovery_rate": _round(recovered / max(faulted, 1)),
            "hedges": fl.hedges,
            "hedge_wins": fl.hedge_wins,
            "hedge_cancelled": fl.hedge_cancelled,
        }
        breakers = [
            (rep.id, rep.sched.breaker)
            for rep in sorted(fl.replicas, key=lambda r: r.id)
            if rep.sched.breaker is not None
        ]
        if breakers:
            transitions = []
            for rid, br in breakers:
                for tr in br.transitions:
                    transitions.append({**tr, "replica": rid})
            transitions.sort(key=lambda tr: (tr["t"], tr["replica"]))
            block["breaker"] = {
                "trips": sum(br.trips for _, br in breakers),
                "restores": sum(br.restores for _, br in breakers),
                "probes": sum(br.probes for _, br in breakers),
                "open_signatures": sorted({s for _, br in breakers for s in br.open_signature_labels()}),
                "transitions": transitions,
            }
        else:
            block["breaker"] = None
        rungs: dict[str, int] = {}
        for e in served:
            rec = e.completion.record
            label = f"{rec.mode}/{rec.executor or '-'}"
            rungs[label] = rungs.get(label, 0) + 1
        block["rungs"] = dict(sorted(rungs.items()))
        return block

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=1, sort_keys=True)


def simulate_fleet(cfg: FleetConfig, engine_factory: Optional[Callable] = None) -> FleetReport:
    """Drive a fresh fleet through one seeded load trace: the arrival
    discipline of the single-server ``simulate`` (arrivals and mix drawn
    before volumes, so payloads never perturb the trace), N servers
    wide."""
    rng = np.random.default_rng(cfg.seed)
    proc = ARRIVAL_PROCESSES[cfg.process]
    times = proc(horizon_s=cfg.horizon_s, rng=rng, **cfg.process_kwargs)
    arrivals = [(t, _sample_mix(cfg.mix, rng)) for t in times]
    vols = [_make_volume(spec, rng, cfg.execute) for _, spec in arrivals]
    if cfg.content_skew is not None:
        # per-index counter-hash identities (simulator.zipf_content_id):
        # skew cannot perturb the arrival and mix draws above
        for idx, ((_, spec), v) in enumerate(zip(arrivals, vols)):
            if isinstance(v, _ShapeStub) and not spec.garbage:
                v.content_id = zipf_content_id(cfg.seed, idx, cfg.content_skew, cfg.content_universe)
    fleet = Fleet(cfg, engine_factory)
    fleet.run(arrivals, vols)
    assert fleet.conserved(), "fleet conservation violated"
    return FleetReport(cfg=cfg, fleet=fleet, arrived=len(arrivals))


# ------------------------------------------------------- scenario presets ---


def fleet_preset(name: str, seed: int = 0, horizon_s: Optional[float] = None) -> FleetConfig:
    """The six fleet scenarios (golden traces):

    ``fleet_steady``    — 3 replicas under 4x the single-server steady
                          rate: the horizontal-scale latency floor and
                          the affinity hit-rate baseline.
    ``fleet_overload``  — the single-server overload (diurnal 12 Hz peak,
                          tight admission, short queues) on a 4-replica
                          cache-affinity fleet.
    ``fleet_failover``  — burst traffic with a replica crash in the middle
                          of the second storm: in-flight and queued work
                          re-dispatched exactly once, nothing lost.
    ``fleet_autoscale`` — a compressed virtual day of diurnal traffic on
                          an autoscaled fleet (1 to 6 replicas).
    ``fleet_faultstorm``— 4 replicas under a seeded fault storm (6 %
                          transients, one permanent-fault signature, a
                          straggler replica, rare stuck members) under the
                          full ``ResiliencePolicy``: retries, timeouts,
                          the breaker ladder and hedging.
    ``fleet_cached``    — 4 replicas behind one shared artifact cache
                          under Zipf content skew, 2 % corrupt entries and
                          a 60-s cache outage.
    """
    from repro_torch.serving.resilience import (
        BreakerConfig,
        FaultPlan,
        FaultRule,
        HedgePolicy,
        ResiliencePolicy,
        RetryPolicy,
    )
    from repro_torch.serving.scheduler import PriorityClass
    from repro_torch.serving.simulator import STANDARD_MIX

    overload_classes = {
        "interactive": PriorityClass("interactive", 0, deadline_s=10.0),
        "standard": PriorityClass("standard", 1, deadline_s=2.5),
        "batch": PriorityClass("batch", 2, deadline_s=30.0),
    }

    def sched(depth=64, admission=512 * 1024 * 1024, classes=None):
        kw = {} if classes is None else {"classes": dict(classes)}
        return SchedulerConfig(
            max_queue_depth=depth, admission_hbm_bytes=admission, max_batch_requests=8, native_shapes=True, **kw
        )

    slow = FleetServiceModel(base_s=0.1, batch_overhead_s=0.05)
    if name == "fleet_steady":
        return FleetConfig(
            name="fleet_steady",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            process="poisson",
            process_kwargs={"rate_hz": 2.0},
            mix=STANDARD_MIX,
            replicas=3,
            policy="cache_affinity",
            scheduler=sched(),
        )
    if name == "fleet_overload":
        return FleetConfig(
            name="fleet_overload",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            # the single-server overload preset's traffic and admission,
            # 4 replicas wide behind cache-affinity routing
            process="diurnal",
            process_kwargs={"peak_hz": 12.0},
            mix=STANDARD_MIX,
            replicas=4,
            policy="cache_affinity",
            scheduler=sched(depth=32, admission=1 * 1024 * 1024, classes=overload_classes),
            service=slow,
        )
    if name == "fleet_failover":
        return FleetConfig(
            name="fleet_failover",
            seed=seed,
            horizon_s=horizon_s or 360.0,
            process="burst",
            process_kwargs={"base_hz": 0.2, "burst_hz": 40.0, "period_s": 120.0, "burst_len_s": 15.0},
            mix=STANDARD_MIX,
            replicas=3,
            policy="cache_affinity",
            scheduler=sched(),
            # slow enough that a 40 Hz storm outruns 3 replicas and queues
            # build before the crash
            service=slow,
            # replica 1 dies in the middle of the second storm ([120, 135]):
            # an in-flight batch cut mid-service plus a queued backlog
            events=(FleetEvent(t=127.0, action="crash", replica=1),),
        )
    if name == "fleet_autoscale":
        return FleetConfig(
            name="fleet_autoscale",
            seed=seed,
            horizon_s=horizon_s or 1800.0,
            # the diurnal ramp peaks mid-horizon well above one replica's
            # capacity, then fades
            process="diurnal",
            process_kwargs={"peak_hz": 12.0},
            mix=STANDARD_MIX,
            replicas=1,
            policy="cache_affinity",
            scheduler=sched(),
            service=slow,
            autoscaler=AutoscalerConfig(
                interval_s=60.0,
                min_replicas=1,
                max_replicas=6,
                slo_class="interactive",
                slo_latency_s=2.0,
                up_attainment=0.9,
                down_attainment=0.98,
                cooldown_s=120.0,
            ),
        )
    if name == "fleet_faultstorm":
        return FleetConfig(
            name="fleet_faultstorm",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            process="poisson",
            process_kwargs={"rate_hz": 6.0},
            mix=STANDARD_MIX,
            replicas=4,
            policy="cache_affinity",
            scheduler=sched(),
            service=slow,
            resilience=ResiliencePolicy(
                retry=RetryPolicy(
                    max_attempts=3, backoff_base_s=0.1, backoff_mult=2.0, backoff_max_s=2.0, jitter_frac=0.25,
                    seed=seed,
                ),
                service_timeout_s={"interactive": 4.0, "standard": 8.0, "batch": 20.0},
                hedge=HedgePolicy(p99_factor=3.0, min_age_s=1.0, min_samples=30, window=200, max_hedges=1),
                breaker=BreakerConfig(trip_after=3, cooldown_s=120.0),
            ),
            fault_plan=FaultPlan(
                seed=seed,
                rules=(
                    # transient noise everywhere
                    FaultRule(kind="transient", rate=0.06),
                    # one poisoned signature: the plain executor's int8w
                    # 32^3 always fails until the breaker walks it down
                    # the ladder
                    FaultRule(
                        kind="permanent", rate=1.0, executor_substr="torch", shape=(32, 32, 32), precision="int8w"
                    ),
                    # replica 2 is a 6x straggler: hedging and timeouts
                    FaultRule(kind="straggler", rate=1.0, replica=2, slow_factor=6.0),
                    # a rare stuck member only a service timeout reaps
                    FaultRule(kind="stuck", rate=0.004),
                ),
            ),
        )
    if name == "fleet_cached":
        return FleetConfig(
            name="fleet_cached",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            # each storm floods the fleet with Zipf-hot content faster
            # than it can serve, so identical requests pile onto in-flight
            # single-flight leaders
            process="burst",
            process_kwargs={"base_hz": 2.0, "burst_hz": 60.0, "period_s": 120.0, "burst_len_s": 15.0},
            mix=STANDARD_MIX,
            replicas=4,
            policy="cache_affinity",
            scheduler=sched(),
            service=slow,
            # Zipf(1.1) over 256 volumes; 2 % of consults land on a
            # bit-flipped entry (quarantined, recomputed, never served);
            # the tier is dark for [240, 300) (the breaker opens, probes,
            # closes), fail-open; 2 MiB against a ~250-artifact working
            # set keeps LRU eviction running
            cache=cache_mod.CacheConfig(capacity_bytes=2 * 1024 * 1024, breaker_trip_after=3, breaker_cooldown_s=30.0),
            content_skew=1.1,
            content_universe=256,
            fault_plan=FaultPlan(
                seed=seed,
                rules=(
                    FaultRule(kind="corrupt_entry", rate=0.02),
                    FaultRule(kind="cache_unavailable", rate=1.0, t0=240.0, t1=300.0),
                ),
            ),
        )
    raise KeyError(
        f"unknown fleet preset {name!r}: fleet_steady | fleet_overload | fleet_failover | fleet_autoscale | "
        "fleet_faultstorm | fleet_cached"
    )


FLEET_PRESETS = (
    "fleet_steady",
    "fleet_overload",
    "fleet_failover",
    "fleet_autoscale",
    "fleet_faultstorm",
    "fleet_cached",
)
