"""Continuous-batching request scheduler in front of ``SegmentationEngine``
— counterpart of ``repro/serving/scheduler.py``.

  * a **request queue** with arrival timestamps and bounded depth —
    overflow is a typed rejection (``QueueFullError``);
  * **priority / deadline classes** (``PriorityClass``): lower priority
    number is served first, FIFO within a class; a class deadline turns
    queue-time overload into typed ``deadline_expired`` shedding;
  * **device-memory-aware admission**: every request's working set is
    priced before dispatch with the ``telemetry/budget.py`` models at the
    request's resolved precision, and a dispatch group grows only while
    the summed working sets fit ``SchedulerConfig.admission_hbm_bytes``.
    A request too large even alone is **demoted** to the sub-volume
    failsafe or, failing that, rejected with ``admission_oom``;
  * **dynamic grouping**: queued requests sharing a resolved ``(mode,
    executor, devices, precision, shape)`` signature are dispatched as
    one group (one prepared weight tree, one bound forward). Signatures
    are resolved once per unique request shape and policy
    (``stats.resolutions`` counts the misses);
  * **per-request telemetry stamping**: arrival, queue wait, service
    time, batch size, priority class and demotion land on the record the
    pipeline emits.

Executors are resolved for the engine's device (``executors.resolve(...,
device=engine.device)``), so a card engine prices and groups under the
executor the card runs (``auto`` is ``cuda_fused`` there, ``torch`` on
the CPU).

The scheduler is clock-agnostic: pass any object with ``now() ->
float``. Production uses the process monotonic clock; the load simulator
(``serving/simulator.py``) passes a virtual clock and a byte-model
service time, which is how its reports are bit-reproducible.

With a ``ResiliencePolicy`` (serving/resilience.py) retryable faults
re-enter their lane behind a seeded backoff, per-class service timeouts
reap stuck attempts on the modeled path, and a per-signature circuit
breaker walks a faulting signature down the degradation ladder and back;
a ``FaultPlan`` injects faults (on the executed path only transient and
permanent raises, before the engine runs). With an ``ArtifactCache``
(serving/cache.py) admission consults the cache: a verified hit or a
negative verdict completes at once, and identical concurrent requests
attach to one in-flight leader. Every completion owns its segmentation:
hits and followers get copies, and so does the cache entry, since a
caller may write into its tensor. The scheduler decides as the
reference's does, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

from repro_torch.core import executors, spatial_shard
from repro_torch.kernels import quantize
from repro_torch.serving import cache as cache_mod
from repro_torch.serving.errors import (  # noqa: F401  (QueueFullError re-exported)
    EXECUTION_FAULT_TYPES,
    PERMANENT_FAULT,
    QueueFullError,
    RETRYABLE_FAIL_TYPES,
    SERVICE_TIMEOUT,
    TRANSIENT_FAULT,
    CacheCorruptionError,
    PermanentExecutorError,
    ResilienceConfigError,
    TransientExecutorError,
    classify,
)
from repro_torch.serving.resilience import SignatureBreaker, demote_rung
from repro_torch.telemetry.budget import MemoryBudget
from repro_torch.telemetry.record import StageTimes, TelemetryRecord


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One admission class. ``priority`` orders dispatch (lower first);
    ``deadline_s`` bounds *queue* time — a request still queued past its
    deadline is shed with a typed ``deadline_expired`` rejection. ``None``
    never expires."""

    name: str
    priority: int
    deadline_s: Optional[float] = None


#: default class ladder: interactive requests preempt batch work and are
#: shed rather than served seconds late; batch work waits indefinitely.
DEFAULT_CLASSES = {
    "interactive": PriorityClass("interactive", 0, deadline_s=30.0),
    "standard": PriorityClass("standard", 1, deadline_s=120.0),
    "batch": PriorityClass("batch", 2, deadline_s=None),
}


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """The compatibility signature of a dispatch group: requests sharing
    it run one bound forward (``executors.bound_apply`` keys on executor
    and precision) over one prepared weight tree."""

    mode: str
    executor: str
    devices: Optional[int]
    precision: str
    shape: tuple


@dataclasses.dataclass
class ServeRequest:
    """One queued segmentation request (internal to the scheduler)."""

    id: int
    vol: Any
    priority_class: PriorityClass
    arrival_s: float
    deadline_s: Optional[float]  # absolute, on the scheduler's clock
    # raw per-request overrides (None = engine defaults)
    mode: Optional[str]
    executor: Optional[str]
    devices: Optional[int]
    precision: Optional[str]
    # resolved admission signature (None for garbage volumes, which are
    # dispatched solo so their typed failure cannot poison a group)
    key: Optional[GroupKey] = None
    bytes_priced: int = 0
    demoted: bool = False
    # resilience state (serving/resilience.py). ``base_key`` is the
    # signature as admitted, before any breaker demotion — the breaker's
    # ledger key and the rung half-open probes retry; ``attempt`` counts
    # completed service attempts (0 == first try); ``not_before_s`` is
    # the retry-backoff gate (the request stays queued but is not
    # batchable until then; its original arrival stamp is untouched, so
    # deadlines and FIFO order stay honest); ``probe`` marks a half-open
    # breaker probe serving at the base rung; ``faults`` counts the
    # retryable faults this request has absorbed (recovery accounting).
    base_key: Optional[GroupKey] = None
    base_bytes: int = 0
    attempt: int = 0
    not_before_s: float = 0.0
    probe: bool = False
    faults: int = 0
    # artifact-cache state (serving/cache.py): the artifact key this
    # request leads for — set when the admission consult missed and this
    # request registered the single-flight in-flight entry; its terminal
    # record is stored under this key and its followers complete with
    # it. None for non-leaders (hits, followers, uncacheable).
    cache_key: Optional[str] = None


@dataclasses.dataclass
class SchedulerConfig:
    """Admission policy knobs.

    ``admission_hbm_bytes=None`` disables the batch-level budget (each
    request still gets the engine's per-request budget-driven mode
    selection) — the configuration ``submit_many`` uses.
    ``max_queue_depth=None`` is an unbounded queue.

    ``native_shapes``: ``False`` (default) conforms every volume to the
    engine's ``volume_shape``, so admission prices that shape; ``True``
    serves each request at its own volume geometry (the simulator's
    heterogeneous mode), pricing, grouping and executing per request
    shape.

    ``batched_dispatch`` prices a dispatch group as one batched launch:
    a request's working set includes one weight-tree copy, and group
    growth charges the weights once per group. On the modeled path
    (``execute=False`` with a service model) the whole group serves in
    one launch whose duration comes from the batch-N byte model, every
    member stamped with the launch's shared service interval. With
    ``execute=True`` members still run one after another through the
    pipeline.
    """

    max_queue_depth: Optional[int] = 64
    admission_hbm_bytes: Optional[int] = None
    max_batch_requests: int = 8
    classes: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_CLASSES))
    allow_demotion: bool = True
    native_shapes: bool = False
    batched_dispatch: bool = False


@dataclasses.dataclass
class SchedulerStats:
    """Conservation ledger. Terminal states are disjoint:

        admitted == completed + demoted + rejected + evacuated + coalesced
        (after drain)

    ``completed`` counts requests that reached service in their admitted
    mode (a typed *execution* failure is still a served request);
    ``demoted`` counts requests served after shed-to-subvolume demotion;
    ``rejected`` counts requests shed before service, by typed reason.
    ``refused`` counts ``QueueFullError`` submissions that were never
    admitted (outside the conservation sum). ``evacuated`` counts
    requests handed back to the caller before service (``evacuate``,
    ``cancel``). ``coalesced`` counts requests that completed by
    attaching to an identical in-flight leader's artifact: they never
    entered the queue and never reached a device.

    The resilience counters count events, not requests (a retried
    request is still exactly one terminal state above), except
    ``faulted_requests`` and ``recovered_requests``, which count
    terminal requests for the recovery rate. ``cache_hits`` counts
    admission-time completions from a verified artifact or a negative
    verdict; those are ordinary ``completed`` requests, stamped
    ``cache_hit``.
    """

    admitted: int = 0
    completed: int = 0
    demoted: int = 0
    rejected: dict = dataclasses.field(default_factory=dict)
    refused: int = 0
    evacuated: int = 0
    batches: int = 0
    grouped_requests: int = 0
    resolutions: int = 0
    max_queue_depth: int = 0
    retries: int = 0
    transient_faults: int = 0
    permanent_faults: int = 0
    timeouts: int = 0
    faulted_requests: int = 0
    recovered_requests: int = 0
    coalesced: int = 0
    cache_hits: int = 0

    def rejected_total(self) -> int:
        return sum(self.rejected.values())

    def conserved(self) -> bool:
        return self.admitted == (
            self.completed + self.demoted + self.rejected_total() + self.evacuated + self.coalesced
        )


@dataclasses.dataclass
class Batch:
    """One dispatch group: compatible requests served back-to-back."""

    requests: list
    start_s: float


@dataclasses.dataclass
class Completion:
    """Terminal record of one admitted request."""

    id: int
    outcome: str  # completed | demoted | rejected | coalesced
    record: TelemetryRecord
    result: Any  # PipelineResult | None (rejections / modeled runs)
    arrival_s: float
    finish_s: float


def _own_copy(result, record):
    """A copy of a PipelineResult whose segmentation no other completion
    and no cache entry shares, carrying ``record``: what a cache hit, a
    coalesced follower and the cache entry itself are given, so a caller
    that writes into its tensor changes nobody else's. None stays None
    (the modeled path and negative verdicts carry no result)."""
    if result is None:
        return None
    seg = result.segmentation
    return dataclasses.replace(result, segmentation=None if seg is None else seg.clone(), record=record)


class _MonotonicClock:
    """Production clock: the process monotonic timer."""

    def now(self) -> float:
        return time.monotonic()


class RequestScheduler:
    """Continuous-batching admission in front of one ``SegmentationEngine``.

    ``clock`` is any object with ``now() -> float`` (default: process
    monotonic time). ``service_model`` maps a finished request's
    telemetry record to a *virtual* service duration (see
    ``simulator.ServiceModel``); without one, service time is measured
    from the clock. ``execute=False`` skips the real pipeline and
    synthesizes records from the byte models — the pure discrete-event
    mode of the load simulator.

    ``resilience`` (a ``ResiliencePolicy``) turns on retries, service
    timeouts and the breaker; ``fault_plan`` (a ``FaultPlan``) is the
    seeded injector; ``replica_id`` keys injection decisions and backoff
    jitter so that replicas de-correlate; ``cache`` (an ``ArtifactCache``)
    is consulted at admission. The windows of a fault plan, the breaker's
    cooldown and retry backoff are on ``clock``: under the production
    clock that is ``time.monotonic()``, so windows are built from
    ``clock.now()``.
    """

    def __init__(
        self,
        engine,
        cfg: Optional[SchedulerConfig] = None,
        *,
        clock=None,
        service_model=None,
        execute: bool = True,
        resilience=None,
        fault_plan=None,
        replica_id: int = 0,
        cache=None,
    ):
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self.clock = clock or _MonotonicClock()
        self.service_model = service_model
        self.execute = execute
        # the artifact cache (serving/cache.py), consulted at admission;
        # ``_followers`` holds the requests attached to each in-flight
        # leader's artifact key
        self.cache = cache
        self._followers: dict[str, list[ServeRequest]] = {}
        self._model_fp: Optional[str] = None
        self.resilience = resilience
        self.fault_plan = fault_plan
        self.replica_id = replica_id
        if resilience is not None:
            resilience.validate_against(self.cfg.classes, fault_plan)
        elif fault_plan is not None and fault_plan.has_stuck():
            raise ResilienceConfigError(
                "FaultPlan injects stuck-forever faults but no ResiliencePolicy (service timeouts) is configured"
            )
        self.breaker = None
        if resilience is not None and resilience.breaker is not None:
            self.breaker = SignatureBreaker(resilience.breaker)
        self.queue: list[ServeRequest] = []
        self.completions: list[Completion] = []
        self.stats = SchedulerStats()
        self._seq = 0
        self._drained = 0  # completions already handed out by drain()
        # resolved signature cache: (shape, mode, executor, devices,
        # precision) -> (GroupKey, priced bytes), one resolution per
        # unique signature across the scheduler's lifetime
        self._sig_cache: dict[tuple, tuple[GroupKey, int]] = {}

    # ------------------------------------------------------------ admission

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
        force: bool = False,
    ) -> int:
        """Enqueue one request; returns its id. Raises ``QueueFullError``
        at the depth limit (the refusal is counted and a typed telemetry
        record is logged). ``force=True`` bypasses the depth limit (a
        router's failover re-dispatch). A request the cache answers (a
        hit, a negative verdict, or a follower of an in-flight leader) is
        terminal at admission and never queued."""
        now = self.clock.now() if arrival_s is None else float(arrival_s)
        cls = self.cfg.classes[priority]
        rid = self._seq
        self._seq += 1
        if (
            not force
            and self.cfg.max_queue_depth is not None
            and len(self.queue) >= self.cfg.max_queue_depth
        ):
            self.stats.refused += 1
            self._log_shed(rid, cls, now, "queue_full")
            raise QueueFullError(len(self.queue), self.cfg.max_queue_depth)
        req = ServeRequest(
            id=rid,
            vol=vol,
            priority_class=cls,
            arrival_s=now,
            deadline_s=None if cls.deadline_s is None else now + cls.deadline_s,
            mode=mode,
            executor=executor,
            devices=devices,
            precision=precision,
        )
        req.key, req.bytes_priced = self._resolve(req)
        req.base_key, req.base_bytes = req.key, req.bytes_priced
        self.stats.admitted += 1
        if self._consult_cache(req, now, force=force):
            return rid
        self.queue.append(req)
        self.stats.max_queue_depth = max(self.stats.max_queue_depth, len(self.queue))
        return rid
    def _resolve(self, req: ServeRequest) -> tuple[Optional[GroupKey], int]:
        """The request's admission signature — mode (the engine's
        budget-driven failsafe selection), executor name, device count,
        storage policy, shape — and its working set priced at that
        policy. Cached per unique raw signature."""
        shape = getattr(req.vol, "shape", None)
        if shape is None or len(tuple(shape)) != 3:
            # Garbage volume: no signature to group on; dispatched solo so
            # its typed failure is isolated from well-formed requests.
            return None, 0
        shape = tuple(int(s) for s in shape)
        raw = (shape, req.mode, req.executor, req.devices, req.precision)
        hit = self._sig_cache.get(raw)
        if hit is None:
            self.stats.resolutions += 1
            hit = self._resolve_uncached(req, shape)
            self._sig_cache[raw] = hit
        return hit

    def _resolve_uncached(self, req, shape) -> tuple[GroupKey, int]:
        eng = self.engine
        # the geometry this request will be served at: its own under
        # native_shapes, else the engine's conform target
        if not self.cfg.native_shapes:
            shape = tuple(int(s) for s in eng.cfg.volume_shape)
        precision = quantize.resolve_precision(req.precision or eng.precision, eng.cfg.model)
        mode = req.mode or eng.pick_mode(shape, precision)
        work_shape = (eng.cfg.cube + 2 * eng.cfg.overlap,) * 3 if mode == "subvolume" else shape
        exec_name = executors.resolve(
            req.executor or eng.cfg.executor, eng.cfg.model, work_shape, precision, device=eng.device
        )
        devices = req.devices if req.devices is not None else eng.devices
        if devices is not None:
            # pipeline.run's device-count rewrap, so that the signature
            # names the backend that will execute (an explicitly
            # "@n"-pinned name still wins over the default)
            inner = executors.inner_of(exec_name)
            parsed = executors.parse_sharded(exec_name)
            pinned = parsed is not None and parsed[1] is not None
            if devices > 1 and executors.shardable(inner) and not pinned:
                exec_name = executors.ensure_sharded(inner, devices)
            elif devices <= 1:
                exec_name = inner
        key = GroupKey(mode=mode, executor=exec_name, devices=devices, precision=precision, shape=shape)
        return key, self._price(mode, shape, precision)

    def _price(self, mode: str, shape, precision: str) -> int:
        """Working-set bytes of one request in ``mode`` at ``precision``:
        the telemetry/budget.py models charged against an unlimited budget
        (so pricing never raises; the admission comparison enforces the
        configured limit). Under ``batched_dispatch`` the price carries
        one weight-tree copy, which group growth charges once per
        group."""
        unl = MemoryBudget.unlimited()
        ab = quantize.act_bytes(precision)
        cfg = self.engine.cfg
        if mode == "subvolume":
            need = unl.charge_subvolume(cfg.cube, cfg.overlap, cfg.model, dtype_bytes=ab)
        elif mode == "streaming":
            need = unl.charge_streaming(shape, cfg.model, dtype_bytes=ab)
        else:
            need = unl.charge_inference(shape, cfg.model, dtype_bytes=ab)
        if self.cfg.batched_dispatch:
            need += quantize.model_params_bytes(cfg.model, precision)
        return need

    def _group_weight_bytes(self, key) -> int:
        """The weight-tree bytes shared by every member of a batched
        dispatch group; 0 under serialized dispatch."""
        if not self.cfg.batched_dispatch or key is None:
            return 0
        return quantize.model_params_bytes(self.engine.cfg.model, key.precision)

    # ------------------------------------------------------- artifact cache

    def _consult_cache(self, req: ServeRequest, now: float, force: bool) -> bool:
        """Admission-time cache consult. Returns True when the request is
        terminal already — served from a verified artifact (``completed``
        and ``cache_hits``), from a negative verdict, or attached as a
        single-flight follower (completes with its leader) — and must not
        enter the queue. Returns False on miss, bypass or an unavailable
        tier: the request serves via compute, fail-open, possibly as the
        new in-flight leader. ``force`` marks failover and hedge copies:
        they may take a clean hit but never lead or follow."""
        if self.cache is None or req.key is None:
            return False
        content = cache_mod.content_hash(req.vol)
        if content is None:
            return False  # no content identity: uncacheable
        if self._model_fp is None:
            self._model_fp = cache_mod.model_fingerprint(self.engine.cfg.model)
        ckey = cache_mod.artifact_key(content, self._model_fp, req.key.precision, req.key.mode)
        look = self.cache.lookup(ckey, now=now, replica=self.replica_id, request_id=req.id, group_key=req.key)
        if look.status in ("unavailable", "bypass"):
            return False  # fail open: compute path, no single-flight
        if look.status == "hit":
            try:
                payload = self.cache.serve_payload(look.entry)
            except CacheCorruptionError:
                # the serve-time guard caught a breach: recompute
                look = cache_mod.Lookup(status="miss", slow_factor=look.slow_factor)
            else:
                self._complete_from_cache(req, payload, look, now, result=look.entry.result)
                return True
        if look.status == "negative":
            self._complete_from_cache(req, None, look, now, fail_type=look.entry.fail_type)
            return True
        if look.status == "inflight":
            if not force and look.owner == self.replica_id:
                req.cache_key = ckey
                self._followers.setdefault(ckey, []).append(req)
                return True
            return False  # a peer's leader: compute independently
        if look.status == "miss" and not force:
            self.cache.begin(
                ckey, replica=self.replica_id, now=now, est_bytes=cache_mod.artifact_bytes_modeled(req.key.shape)
            )
            req.cache_key = ckey
        if look.slow_factor > 1.0:
            # a slow consult delays this request's batch eligibility by the
            # inflated verify cost — latency degradation, fail-open
            req.not_before_s = max(req.not_before_s, now + self.cache.cfg.verify_s * look.slow_factor)
        return False

    def _complete_from_cache(
        self,
        req: ServeRequest,
        payload: Optional[dict],
        look,
        now: float,
        *,
        fail_type: Optional[str] = None,
        result=None,
    ) -> None:
        """Terminal completion at admission: the verified artifact's
        metadata (or the negative verdict) becomes this request's record,
        stamped ``cache_hit`` — no queue, no batch, no device. ``wait +
        service == finish - arrival`` holds with wait 0 and service the
        (possibly slowed) verify cost. The result is a copy of the
        entry's, owned by this completion."""
        service = self.cache.cfg.verify_s * look.slow_factor
        finish = now + service
        negative = payload is None
        rec = TelemetryRecord(
            model=self.engine.cfg.name,
            mode=(payload or {}).get("mode") or req.key.mode,
            status="fail" if negative else "ok",
            times=StageTimes(),
            executor=(payload or {}).get("executor") or req.key.executor,
            precision=(payload or {}).get("precision") or req.key.precision,
            params_bytes=(payload or {}).get("params_bytes"),
            fail_type=fail_type,
            request_id=req.id,
            arrival_s=req.arrival_s,
            queue_wait_s=0.0,
            service_s=service,
            batch_size=1,
            priority_class=req.priority_class.name,
            cache_hit=True,
            extra=({"negative_cache": True} if negative else {"artifact_checksum": look.entry.checksum[:16]}),
        )
        self.engine.log.append(rec)
        self.stats.completed += 1
        self.stats.cache_hits += 1
        self.completions.append(
            Completion(
                id=req.id,
                outcome="completed",
                record=rec,
                result=_own_copy(result, rec),
                arrival_s=req.arrival_s,
                finish_s=finish,
            )
        )

    def _complete_cache_leader(self, req: ServeRequest, rec, result, finish: float) -> None:
        """Fold a single-flight leader's terminal record into the cache and
        complete every attached follower with its artifact — outcome
        ``coalesced``, stamped ``cache_hit``, one artifact checksum. N
        identical concurrent requests == 1 execution + N-1 coalesced
        completions. The cache entry and each follower get copies of the
        leader's result of their own.

        Two guards before anything is stored or coalesced:

        * a record whose (mode, precision) differ from the admission form
          the artifact key was derived from must not be stored under
          that key (``_release_stale_lead`` catches the demotion and
          ladder paths at mutation time; this is the backstop);
        * a retryable-class terminal failure (an exhausted transient
          budget, a service timeout) is one leader's bad luck, not a
          property of the content: followers re-enter the queue with
          their own retry budgets. (A permanent fault does coalesce: the
          verdict is content-determined and is negative-cached.)"""
        stale = req.base_key is not None and (rec.mode, rec.precision) != (req.base_key.mode, req.base_key.precision)
        retryable_failure = rec.status == "fail" and rec.fail_type in RETRYABLE_FAIL_TYPES
        if stale or retryable_failure:
            self._release_lead(req)
            return
        ckey = req.cache_key
        checksum = self.cache.complete(
            ckey,
            now=finish,
            record=rec,
            result=_own_copy(result, rec),
            shape=req.key.shape if req.key is not None else (0, 0, 0),
            replica=self.replica_id,
            request_id=req.id,
        )
        if checksum is not None:
            rec.extra = {**rec.extra, "artifact_checksum": checksum[:16]}
        for f in self._followers.pop(ckey, []):
            frec = dataclasses.replace(
                rec,
                request_id=f.id,
                arrival_s=f.arrival_s,
                queue_wait_s=max(0.0, finish - f.arrival_s),
                service_s=0.0,
                cache_hit=True,
                attempt=0,
            )
            self.engine.log.append(frec)
            self.stats.coalesced += 1
            self.completions.append(
                Completion(
                    id=f.id,
                    outcome="coalesced",
                    record=frec,
                    result=_own_copy(result, frec),
                    arrival_s=f.arrival_s,
                    finish_s=finish,
                )
            )

    # ------------------------------------------------------------ dispatch

    def _seed_index(self, ready: list[int]) -> int:
        """Oldest ready request of the highest-priority class (FIFO within
        a class; ids break arrival ties). ``ready`` indexes the queue
        entries not gated by a retry backoff."""
        return min(
            ready,
            key=lambda i: (
                self.queue[i].priority_class.priority,
                self.queue[i].arrival_s,
                self.queue[i].id,
            ),
        )

    def _shed_expired(self, now: float) -> None:
        for req in [r for r in self.queue if r.deadline_s is not None and now > r.deadline_s]:
            self.queue.remove(req)
            self._reject(req, "deadline_expired", now)

    def _reject(self, req: ServeRequest, reason: str, now: float) -> None:
        self.stats.rejected[reason] = self.stats.rejected.get(reason, 0) + 1
        rec = self._log_shed(req.id, req.priority_class, req.arrival_s, reason, now=now)
        self.completions.append(
            Completion(id=req.id, outcome="rejected", record=rec, result=None, arrival_s=req.arrival_s, finish_s=now)
        )
        # a shed single-flight leader must not strand its followers: they
        # re-enter the queue to serve independently
        self._release_lead(req)

    def _release_lead(self, req: ServeRequest) -> None:
        """Release a leader's single-flight pin without completing it: the
        pending placeholder is abandoned (bytes credited back) and every
        attached follower re-enters the queue as an independent request.
        A no-op on non-leaders."""
        if req.cache_key is None or self.cache is None:
            return
        ckey, req.cache_key = req.cache_key, None
        if self.cache.inflight_owner(ckey) == self.replica_id:
            self.cache.abandon(ckey)
        for f in self._followers.pop(ckey, []):
            f.cache_key = None
            self.queue.append(f)
        if self.queue:
            self.stats.max_queue_depth = max(self.stats.max_queue_depth, len(self.queue))

    def _log_shed(self, rid, cls, arrival, reason, now=None):
        """Typed telemetry for a request shed before service."""
        now = arrival if now is None else now
        rec = TelemetryRecord(
            model=self.engine.cfg.name,
            mode="none",
            status="fail",
            times=StageTimes(),
            fail_type=reason,
            request_id=rid,
            arrival_s=arrival,
            queue_wait_s=max(0.0, now - arrival),
            priority_class=cls.name,
        )
        self.engine.log.append(rec)
        return rec

    def next_batch(self, now: Optional[float] = None) -> Optional[Batch]:
        """Form the next dispatch group at time ``now``: shed expired
        deadlines, pick the seed (priority order, FIFO within class), pin
        it to its breaker rung, apply admission (demote or reject an
        over-budget seed), then grow the group with same-class,
        same-signature requests while the summed working sets fit the
        admission budget."""
        now = self.clock.now() if now is None else now
        while True:
            self._shed_expired(now)
            ready = [i for i, r in enumerate(self.queue) if r.not_before_s <= now]
            if not ready:
                # an empty queue, or every queued request in retry backoff:
                # next_ready_s() says when to wake
                return None
            seed = self.queue.pop(self._seed_index(ready))
            self._apply_breaker(seed, now)
            cap = self.cfg.admission_hbm_bytes
            if cap is not None and seed.key is not None and seed.bytes_priced > cap:
                form = self._demoted_form(seed)
                if form is None or form[1] > cap:
                    self._reject(seed, "admission_oom", now)
                    continue  # try the next seed
                self._apply_demotion(seed, *form)
            members = [seed]
            total = seed.bytes_priced
            # Batched dispatch streams the weights once a group: each
            # joiner is charged its marginal bytes (bts - w_shared); the
            # seed's copy stays in ``total``.
            w_shared = self._group_weight_bytes(seed.key)
            if seed.key is not None:
                for req in [r for r in self.queue]:
                    if len(members) >= self.cfg.max_batch_requests:
                        break
                    if req.not_before_s > now:
                        continue  # still gated by a retry backoff
                    # a candidate is judged at the form it would serve in:
                    # its breaker rung first (peeked, so no probe slot is
                    # claimed for a request not taken), then, over the cap,
                    # its demoted form, so that requests an overload
                    # demotes still batch together
                    key, bts, via_demotion = req.key, req.bytes_priced, False
                    if self.breaker is not None and req.base_key is not None:
                        key, bts = self._breaker_form(req, self.breaker.peek_rung(req.base_key, now))
                    if cap is not None and key is not None and bts > cap:
                        form = self._demoted_form(req)
                        if form is None or form[1] > cap:
                            continue  # unservable; rejected when seeded
                        key, bts = form
                        via_demotion = True
                    if (
                        key == seed.key
                        and req.priority_class.name == seed.priority_class.name
                        and (cap is None or total + (bts - w_shared) <= cap)
                    ):
                        self.queue.remove(req)
                        self._apply_breaker(req, now)
                        if via_demotion:
                            self._apply_demotion(req, key, bts)
                        members.append(req)
                        total += bts - w_shared
            members.sort(key=lambda r: (r.arrival_s, r.id))
            self.stats.batches += 1
            self.stats.grouped_requests += len(members) - 1
            return Batch(requests=members, start_s=now)

    def _demoted_form(self, req: ServeRequest) -> Optional[tuple[GroupKey, int]]:
        """The request's shed-to-subvolume form — (failsafe GroupKey,
        re-priced bytes) — without mutating the request. None when
        demotion is off or the request already runs sub-volume."""
        if not self.cfg.allow_demotion or req.key is None or req.key.mode == "subvolume":
            return None
        eng = self.engine
        work_shape = (eng.cfg.cube + 2 * eng.cfg.overlap,) * 3
        key = GroupKey(
            mode="subvolume",
            executor=executors.resolve(
                req.executor or eng.cfg.executor, eng.cfg.model, work_shape, req.key.precision, device=eng.device
            ),
            devices=req.key.devices,
            precision=req.key.precision,
            shape=req.key.shape,
        )
        return key, self._price("subvolume", req.key.shape, req.key.precision)

    def _apply_demotion(self, req: ServeRequest, key: GroupKey, bts: int) -> None:
        req.key = key
        req.bytes_priced = bts
        req.demoted = True
        self._release_stale_lead(req)

    def _release_stale_lead(self, req: ServeRequest) -> None:
        """A leader's artifact key was derived at admission from its
        resolved (mode, precision), the axes ``cache.artifact_key`` bakes
        in because they change the artifact. Admission demotion and the
        breaker ladder change ``req.key`` after that, so a demoted or
        ladder-degraded leader releases its lead (pin abandoned,
        followers re-queued) and the wrong-key store never lands. A no-op
        while the effective (mode, precision) match ``base_key``'s."""
        if req.cache_key is None or req.key is None or req.base_key is None:
            return
        if (req.key.mode, req.key.precision) != (req.base_key.mode, req.base_key.precision):
            self._release_lead(req)

    def _breaker_form(self, req: ServeRequest, rung: int) -> tuple[GroupKey, int]:
        """The (key, priced bytes) ``req`` serves at ``rung`` steps down
        the degradation ladder from its base signature, re-resolved
        through the executor registry and re-priced for admission. Rung 0
        is the base form (a restored breaker or a half-open probe); the
        walk caps at the ladder's bottom rung."""
        if rung <= 0:
            return req.base_key, req.base_bytes
        key = req.base_key
        for _ in range(rung):
            nxt = demote_rung(key, self.engine)
            if nxt is None:
                break  # already at the sub-volume failsafe
            key = nxt
        return key, self._price(key.mode, key.shape, key.precision)

    def _apply_breaker(self, req: ServeRequest, now: float) -> None:
        """Pin the request to its breaker-effective form on admission to a
        batch: claims the half-open probe slot when this request is the
        probe, walks the ladder otherwise. ``demoted`` tracks whether the
        effective mode is the sub-volume failsafe, so ladder restores
        un-demote and ladder bottoms count as demotions."""
        if self.breaker is None or req.base_key is None:
            return
        rung, probe = self.breaker.effective_rung(req.base_key, now)
        req.key, req.bytes_priced = self._breaker_form(req, rung)
        req.probe = probe
        req.demoted = req.key.mode == "subvolume" and req.base_key.mode != "subvolume"
        self._release_stale_lead(req)

    # ------------------------------------------------------------ service

    def run_batch(self, batch: Batch, now: Optional[float] = None) -> float:
        """Serve one dispatch group. Members run back-to-back. Each
        member's telemetry is stamped with queue wait, service time and
        the group size; a member that *raises* (garbage volume, a kernel
        that fails, an injected fault) gets a typed failure record
        classified along the transient/permanent axis (serving/errors.py)
        while the rest of the group completes. Returns the batch finish
        time."""
        t, unserved = self.run_batch_until(batch, None, now=now)
        assert not unserved  # until=None serves every member
        return t

    def run_batch_until(
        self, batch: Batch, until: Optional[float], now: Optional[float] = None
    ) -> tuple[float, list]:
        """``run_batch`` with a service horizon: serve members in order
        while each would *finish* by ``until`` (virtual seconds), then
        stop. Returns ``(finish_time, unserved_tail)``; the tail members
        were never executed, logged or counted. ``until=None`` serves
        everything. A finite ``until`` requires the modeled path (a
        service model and ``execute=False``): truncation must predict each
        member's duration before running it."""
        if until is not None and (self.execute or self.service_model is None):
            raise ValueError(
                "run_batch_until with a finite horizon requires the "
                "modeled path (execute=False and a service model)"
            )
        start = batch.start_s if now is None else now
        t = start
        if self.service_model is not None:
            t += self.service_model.batch_overhead_s
        if (
            self.cfg.batched_dispatch
            and self.service_model is not None
            and not self.execute
            and len(batch.requests) > 1
            and batch.requests[0].key is not None
        ):
            return self._run_batched_launch(batch, until, t)
        for idx, req in enumerate(batch.requests):
            if until is not None:
                # preview the member's modeled duration without serving it:
                # _attempt_record and _attempt_service are pure, so the
                # preview matches the serve, injected faults included
                preview, p_decision = self._attempt_record(req, t)
                p_service, _ = self._attempt_service(preview, p_decision, req)
                if t + p_service > until:
                    return t, list(batch.requests[idx:])
            result, rec, decision = self._serve_one(req, t)
            if self.service_model is not None:
                service, timed_out = self._attempt_service(rec, decision, req)
                if timed_out:
                    # cancelled at the bound: the member held the replica
                    # for exactly the timeout, and the fault is retryable
                    rec.status = "fail"
                    rec.fail_type = SERVICE_TIMEOUT
            else:
                service = max(0.0, self.clock.now() - t)
            finish = t + service
            rec.request_id = req.id
            rec.arrival_s = req.arrival_s
            # wait = until this member's forward starts (batch overhead and
            # predecessors' service included), so queue_wait_s + service_s
            # == finish - arrival exactly; retried attempts keep the
            # original arrival
            rec.queue_wait_s = max(0.0, t - req.arrival_s)
            rec.service_s = service
            rec.batch_size = len(batch.requests)
            rec.priority_class = req.priority_class.name
            rec.demoted = req.demoted
            rec.attempt = req.attempt
            self._finish_attempt(req, rec, result, finish)
            t = finish
        return t, []

    def _run_batched_launch(self, batch: Batch, until: Optional[float], t: float) -> tuple[float, list]:
        """Serve a dispatch group as one batched launch (modeled path,
        ``batched_dispatch`` only): the launch's service interval comes
        from a single batch-N modeled record, and every member shares it,
        so ``queue_wait_s + service_s == finish - arrival`` holds per
        member. Fault injection stays per member, but a straggler or stuck
        member slows the whole launch, and the class service timeout
        clips it, failing the still-ok members with ``service_timeout``.
        Horizon truncation is all-or-nothing."""
        reqs = batch.requests
        n = len(reqs)
        attempts = [self._attempt_record(req, t) for req in reqs]
        service = self.service_model.service_s(self._modeled_record(reqs[0], batch=n))
        factor, stuck = 1.0, False
        for rec, decision in attempts:
            if decision is not None and rec.status == "ok":
                if decision.kind == "straggler":
                    factor = max(factor, decision.slow_factor)
                elif decision.kind == "stuck":
                    stuck = True
        service = math.inf if stuck else service * factor
        timeout = None if self.resilience is None else self.resilience.timeout_for(reqs[0].priority_class.name)
        timed_out = False
        if timeout is not None and service > timeout:
            service, timed_out = timeout, True
        if math.isinf(service):
            raise ResilienceConfigError(
                f"stuck fault on class {reqs[0].priority_class.name!r} with no service timeout configured"
            )
        finish = t + service
        if until is not None and finish > until:
            return t, list(reqs)
        for req, (rec, decision) in zip(reqs, attempts):
            self.engine.log.append(rec)
            if timed_out and rec.status == "ok":
                rec.status, rec.fail_type = "fail", SERVICE_TIMEOUT
            rec.request_id = req.id
            rec.arrival_s = req.arrival_s
            rec.queue_wait_s = max(0.0, t - req.arrival_s)
            rec.service_s = service
            rec.batch_size = n
            rec.priority_class = req.priority_class.name
            rec.demoted = req.demoted
            rec.attempt = req.attempt
            self._finish_attempt(req, rec, None, finish)
        return finish, []

    def _finish_attempt(self, req, rec, result, finish: float) -> None:
        """Fold one finished service attempt into the breaker, retry and
        conservation state. A retryable fault with budget left is not
        terminal: the request re-enters its lane (original arrival stamp,
        backoff-gated) and no Completion is appended. Everything else is
        terminal; a terminal single-flight leader stores its artifact and
        completes its followers."""
        is_fault = rec.status == "fail" and rec.fail_type in EXECUTION_FAULT_TYPES
        if is_fault:
            if rec.fail_type == TRANSIENT_FAULT:
                self.stats.transient_faults += 1
            elif rec.fail_type == PERMANENT_FAULT:
                self.stats.permanent_faults += 1
            else:
                self.stats.timeouts += 1
        if self.breaker is not None and req.base_key is not None:
            self.breaker.on_result(req.base_key, fault=is_fault, probe=req.probe, now=finish)
        retryable = rec.status == "fail" and rec.fail_type in RETRYABLE_FAIL_TYPES
        if retryable:
            req.faults += 1
        if retryable and self.resilience is not None and req.attempt + 1 < self.resilience.retry.max_attempts:
            req.attempt += 1
            req.probe = False
            req.not_before_s = finish + self.resilience.retry.backoff_s(req.attempt, self.replica_id, req.id)
            self.stats.retries += 1
            self.queue.append(req)
            self.stats.max_queue_depth = max(self.stats.max_queue_depth, len(self.queue))
            return
        outcome = "demoted" if req.demoted else "completed"
        if req.demoted:
            self.stats.demoted += 1
        else:
            self.stats.completed += 1
        if req.faults:
            self.stats.faulted_requests += 1
            if rec.status == "ok":
                self.stats.recovered_requests += 1
        self.completions.append(
            Completion(id=req.id, outcome=outcome, record=rec, result=result, arrival_s=req.arrival_s, finish_s=finish)
        )
        if req.cache_key is not None and self.cache is not None:
            self._complete_cache_leader(req, rec, result, finish)

    def _fault_decision(self, req: ServeRequest, t: float):
        """The seeded injector's verdict for this attempt — pure in (plan
        seed, time, replica, effective signature, request id, attempt).
        Keyed on the effective key: a breaker-demoted signature escapes
        rules that match only its faulty rung, which is what lets the
        ladder route around a poisoned executor."""
        if self.fault_plan is None or req.key is None:
            return None
        return self.fault_plan.decide(
            t=t,
            replica=self.replica_id,
            key=req.key,
            request_id=req.id,
            attempt=req.attempt,
            priority=req.priority_class.name,
        )

    def _attempt_record(self, req: ServeRequest, t: float):
        """(modeled record, fault decision) for one attempt at ``t`` — no
        logging, no state: the truncation preview and the serve call this
        with identical arguments and must agree."""
        rec = self._modeled_record(req)
        decision = self._fault_decision(req, t)
        if decision is not None and rec.status == "ok":
            if decision.kind == "transient":
                rec.status, rec.fail_type = "fail", TRANSIENT_FAULT
            elif decision.kind == "permanent":
                rec.status, rec.fail_type = "fail", PERMANENT_FAULT
            if rec.status == "fail":
                rec.extra = {"injected": decision.kind, "rule": decision.rule_index}
        return rec, decision

    def _attempt_service(self, rec, decision, req: ServeRequest):
        """(service_s, timed_out) for one modeled attempt: the service
        model's duration, inflated by an injected straggler factor,
        infinite for a stuck fault, then clipped at the class's service
        timeout. The clip is the cancellation. A stuck fault with no
        timeout is unservable and raises typed."""
        service = self.service_model.service_s(rec)
        if decision is not None and rec.status == "ok":
            if decision.kind == "straggler":
                service *= decision.slow_factor
            elif decision.kind == "stuck":
                service = math.inf
        timeout = None if self.resilience is None else self.resilience.timeout_for(req.priority_class.name)
        if timeout is not None and service > timeout:
            return timeout, True
        if math.isinf(service):
            raise ResilienceConfigError(
                f"stuck fault on class {req.priority_class.name!r} with no service timeout configured"
            )
        return service, False

    def evacuate(self, now: Optional[float] = None) -> list:
        """Hand every queued request back to the caller (a router's
        failover or drain re-dispatch): the queue empties, each popped
        request counts as ``evacuated``. Single-flight state goes with the
        queue: every follower is handed back too, and every in-flight
        cache pin this replica owns is abandoned, so no pinned
        placeholder outlives it. Returns the requests in (arrival, id)
        order."""
        out = list(self.queue)
        self.queue.clear()
        if self.cache is not None:
            for lst in self._followers.values():
                for f in lst:
                    f.cache_key = None
                    out.append(f)
            self._followers.clear()
            for req in out:
                if req.cache_key is not None:
                    self.cache.abandon(req.cache_key)
                    req.cache_key = None
            for ckey, owner in list(self.cache.inflight.items()):
                if owner == self.replica_id:
                    self.cache.abandon(ckey)
        out.sort(key=lambda r: (r.arrival_s, r.id))
        self.stats.evacuated += len(out)
        return out

    def cancel(self, rid: int):
        """Remove one queued request before service (a hedge loser whose
        twin completed elsewhere), counted ``evacuated``. Returns the
        request, or None when it is not queued — and then nothing
        changes. A cancelled single-flight leader releases its pin and
        re-queues its followers; a cancelled follower leaves its leader's
        list without disturbing the leader."""
        for req in self.queue:
            if req.id == rid:
                self.queue.remove(req)
                self.stats.evacuated += 1
                self._release_lead(req)
                return req
        for ckey in list(self._followers):
            for f in self._followers[ckey]:
                if f.id == rid:
                    self._followers[ckey].remove(f)
                    if not self._followers[ckey]:
                        del self._followers[ckey]
                    f.cache_key = None
                    self.stats.evacuated += 1
                    return f
        return None

    def next_ready_s(self, now: float) -> Optional[float]:
        """When every queued request is gated by a retry backoff, the
        earliest ``not_before_s`` — the wake time an event loop must
        advance to. None when the queue is empty or some request is ready
        now."""
        if not self.queue:
            return None
        earliest = min(r.not_before_s for r in self.queue)
        return earliest if earliest > now else None

    def peek_signature(
        self,
        vol,
        *,
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        devices: Optional[int] = None,
        precision: Optional[str] = None,
    ) -> tuple[Optional[GroupKey], int]:
        """The admission signature and priced bytes a request would get,
        without enqueueing it (a router's affinity key). Shares the
        resolution cache, so peeking then submitting costs one
        resolution."""
        probe = ServeRequest(
            id=-1,
            vol=vol,
            priority_class=PriorityClass("peek", 0),
            arrival_s=0.0,
            deadline_s=None,
            mode=mode,
            executor=executor,
            devices=devices,
            precision=precision,
        )
        return self._resolve(probe)

    def _serve_one(self, req: ServeRequest, t: float):
        """(PipelineResult | None, TelemetryRecord, FaultDecision | None)
        for one service attempt: real execution with typed-failure
        capture, or the modeled record of the discrete-event mode. On the
        executed path an injected transient or permanent fault raises
        before the engine runs, so it launches nothing; a raised
        exception is classified along the transient/permanent axis, its
        text kept in ``record.extra["error"]``."""
        key = req.key
        if not self.execute:
            rec, decision = self._attempt_record(req, t)
            self.engine.log.append(rec)
            return None, rec, decision
        decision = self._fault_decision(req, t)
        try:
            if decision is not None and decision.kind in ("transient", "permanent"):
                err = TransientExecutorError if decision.kind == "transient" else PermanentExecutorError
                raise err(f"injected {decision.kind} fault (rule {decision.rule_index})")
            result = self.engine._run_request(
                req.vol,
                mode=key.mode if key else req.mode,
                executor=key.executor if key else req.executor,
                devices=key.devices if key else req.devices,
                precision=key.precision if key else req.precision,
                # native-shape mode serves the request at its own geometry
                # (the shape admission priced); else the engine conforms
                # to its own shape
                volume_shape=key.shape if key and self.cfg.native_shapes else None,
            )
            return result, result.record, decision
        except Exception as e:  # fault isolation: one bad request != batch
            rec = TelemetryRecord(
                model=self.engine.cfg.name,
                mode=key.mode if key else "none",
                status="fail",
                times=StageTimes(),
                executor=key.executor if key else None,
                precision=key.precision if key else None,
                fail_type=classify(e),
                extra={"error": f"{type(e).__name__}: {e}"},
            )
            self.engine.log.append(rec)
            return None, rec, decision

    def _modeled_record(self, req: ServeRequest, batch: int = 1) -> TelemetryRecord:
        """Synthesized telemetry for ``execute=False`` runs: status and
        modeled bytes from the pre-flight models the pipeline uses, with
        no compute. ``batch > 1`` models an N-volume batched launch."""
        key = req.key
        if key is None:
            return TelemetryRecord(
                model=self.engine.cfg.name,
                mode="none",
                status="fail",
                times=StageTimes(),
                fail_type=PERMANENT_FAULT,
                extra={"error": "garbage volume (modeled)"},
            )
        cfg = self.engine.cfg
        dev = self.engine.device
        rec = TelemetryRecord(
            model=cfg.name,
            mode=key.mode,
            status="ok",
            times=StageTimes(),
            executor=key.executor,
            precision=key.precision,
            params_bytes=quantize.model_params_bytes(cfg.model, key.precision),
        )
        try:
            if key.devices is not None and key.devices > 1:
                have = spatial_shard.device_count(dev.type)
                if key.devices > have:
                    raise spatial_shard.ShardGeometryError(
                        f"sharded executor wants {key.devices} devices; host has {have}"
                    )
            if key.mode == "subvolume":
                ncubes = math.prod(-(-s // cfg.cube) for s in key.shape)
                cube_shape = (cfg.cube + 2 * cfg.overlap,) * 3
                per = executors.modeled_hbm_bytes(
                    key.executor, cfg.model, cube_shape, batch=batch, precision=key.precision, device=dev
                )
                rec.hbm_bytes_modeled = None if per is None else ncubes * per
                rec.collective_bytes_modeled = ncubes * executors.modeled_collective_bytes(
                    key.executor, cfg.model, cube_shape, batch=batch, precision=key.precision, device=dev
                )
            else:
                rec.hbm_bytes_modeled = executors.modeled_hbm_bytes(
                    key.executor, cfg.model, key.shape, batch=batch, precision=key.precision, device=dev
                )
                rec.collective_bytes_modeled = executors.modeled_collective_bytes(
                    key.executor, cfg.model, key.shape, batch=batch, precision=key.precision, device=dev
                )
        except ValueError as e:
            rec.status = "fail"
            rec.fail_type = "shard_geometry" if isinstance(e, spatial_shard.ShardGeometryError) else "vmem_oom"
        return rec

    # ------------------------------------------------------------ draining

    def has_work(self) -> bool:
        return bool(self.queue)

    def drain(self) -> list[Completion]:
        """Serve until the queue is empty; returns the completions new
        since the previous drain, id-ordered, so that a submit/drain loop
        never re-delivers a result. ``self.completions`` keeps the full
        ledger."""
        while True:
            batch = self.next_batch()
            if batch is None:
                if not self.queue:
                    break
                # every queued request is gated: pass the time
                wake = self.next_ready_s(self.clock.now())
                if wake is None:
                    continue
                if hasattr(self.clock, "advance_to"):
                    self.clock.advance_to(wake)
                else:
                    time.sleep(max(0.0, wake - self.clock.now()))
                continue
            self.run_batch(batch)
        assert self.stats.conserved(), f"conservation violated: {self.stats}"
        fresh = self.completions[self._drained:]
        self._drained = len(self.completions)
        return sorted(fresh, key=lambda c: c.id)
