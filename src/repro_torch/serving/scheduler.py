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

Retries, service timeouts, the circuit breaker's degradation ladder,
seeded fault injection and the artifact cache are not ported yet
(ROADMAP.md, Queue 1 item 13b): ``RequestScheduler`` raises
``ValueError`` when given a resilience policy, a fault plan or a cache.
Without them it decides as the reference's does, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

from repro_torch.core import executors, spatial_shard
from repro_torch.kernels import quantize
from repro_torch.serving.errors import (  # noqa: F401  (QueueFullError re-exported)
    NOT_PORTED_13B,
    PERMANENT_FAULT,
    QueueFullError,
    TRANSIENT_FAULT,
    classify,
)
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
    # the time before which the request is not batchable: a retry
    # policy's backoff (item 13b); without one every request is ready at
    # once
    not_before_s: float = 0.0


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

        admitted == completed + demoted + rejected + evacuated
        (after drain)

    ``completed`` counts requests that reached service in their admitted
    mode (a typed *execution* failure is still a served request);
    ``demoted`` counts requests served after shed-to-subvolume demotion;
    ``rejected`` counts requests shed before service, by typed reason.
    ``refused`` counts ``QueueFullError`` submissions that were never
    admitted (outside the conservation sum). ``evacuated`` counts
    requests handed back to the caller before service (``evacuate``,
    ``cancel``). ``transient_faults`` and ``permanent_faults`` count the
    served requests whose executor raised, by class (item 13b's retries,
    timeouts and cache, and their counters, are not ported yet).
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
    transient_faults: int = 0
    permanent_faults: int = 0

    def rejected_total(self) -> int:
        return sum(self.rejected.values())

    def conserved(self) -> bool:
        return self.admitted == self.completed + self.demoted + self.rejected_total() + self.evacuated


@dataclasses.dataclass
class Batch:
    """One dispatch group: compatible requests served back-to-back."""

    requests: list
    start_s: float


@dataclasses.dataclass
class Completion:
    """Terminal record of one admitted request."""

    id: int
    outcome: str  # completed | demoted | rejected
    record: TelemetryRecord
    result: Any  # PipelineResult | None (rejections / modeled runs)
    arrival_s: float
    finish_s: float


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

    ``resilience``, ``fault_plan`` and ``cache`` are the reference's
    hooks for item 13b; anything but None raises ``ValueError``.
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
        cache=None,
    ):
        for name, given in (("resilience", resilience), ("fault_plan", fault_plan), ("cache", cache)):
            if given is not None:
                raise ValueError(f"RequestScheduler({name}=...): {NOT_PORTED_13B}")
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self.clock = clock or _MonotonicClock()
        self.service_model = service_model
        self.execute = execute
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
        router's failover re-dispatch)."""
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
        self.stats.admitted += 1
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

    # ------------------------------------------------------------ dispatch

    def _seed_index(self, ready: list[int]) -> int:
        """Oldest ready request of the highest-priority class (FIFO within
        a class; ids break arrival ties)."""
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
        deadlines, pick the seed (priority order, FIFO within class),
        apply admission (demote or reject an over-budget seed), then grow
        the group with same-class, same-signature requests while the
        summed working sets fit the admission budget."""
        now = self.clock.now() if now is None else now
        while True:
            self._shed_expired(now)
            ready = [i for i, r in enumerate(self.queue) if r.not_before_s <= now]
            if not ready:
                return None
            seed = self.queue.pop(self._seed_index(ready))
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
                        continue
                    # a candidate is judged at the form it would serve in:
                    # over the cap, its demoted form, so that requests an
                    # overload demotes still batch together
                    key, bts, via_demotion = req.key, req.bytes_priced, False
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

    # ------------------------------------------------------------ service

    def run_batch(self, batch: Batch, now: Optional[float] = None) -> float:
        """Serve one dispatch group. Members run back-to-back. Each
        member's telemetry is stamped with queue wait, service time and
        the group size; a member that *raises* (garbage volume, a kernel
        that fails) gets a typed failure record classified along the
        transient/permanent axis (serving/errors.py) while the rest of
        the group completes. Returns the batch finish time."""
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
                # preview the member's modeled duration without serving it
                if t + self.service_model.service_s(self._modeled_record(req)) > until:
                    return t, list(batch.requests[idx:])
            result, rec = self._serve_one(req)
            if self.service_model is not None:
                service = self.service_model.service_s(rec)
            else:
                service = max(0.0, self.clock.now() - t)
            finish = t + service
            rec.request_id = req.id
            rec.arrival_s = req.arrival_s
            # wait = until this member's forward starts (batch overhead and
            # predecessors' service included), so queue_wait_s + service_s
            # == finish - arrival exactly
            rec.queue_wait_s = max(0.0, t - req.arrival_s)
            rec.service_s = service
            rec.batch_size = len(batch.requests)
            rec.priority_class = req.priority_class.name
            rec.demoted = req.demoted
            self._finish_attempt(req, rec, result, finish)
            t = finish
        return t, []

    def _run_batched_launch(self, batch: Batch, until: Optional[float], t: float) -> tuple[float, list]:
        """Serve a dispatch group as one batched launch (modeled path,
        ``batched_dispatch`` only): the launch's service interval comes
        from a single batch-N modeled record, and every member shares it,
        so ``queue_wait_s + service_s == finish - arrival`` holds per
        member. Horizon truncation is all-or-nothing."""
        reqs = batch.requests
        n = len(reqs)
        records = [self._modeled_record(req) for req in reqs]
        service = self.service_model.service_s(self._modeled_record(reqs[0], batch=n))
        finish = t + service
        if until is not None and finish > until:
            return t, list(reqs)
        for req, rec in zip(reqs, records):
            self.engine.log.append(rec)
            rec.request_id = req.id
            rec.arrival_s = req.arrival_s
            rec.queue_wait_s = max(0.0, t - req.arrival_s)
            rec.service_s = service
            rec.batch_size = n
            rec.priority_class = req.priority_class.name
            rec.demoted = req.demoted
            self._finish_attempt(req, rec, None, finish)
        return finish, []

    def _finish_attempt(self, req, rec, result, finish: float) -> None:
        """Fold one finished service attempt into the fault counters and
        the conservation ledger, and append its completion."""
        if rec.status == "fail" and rec.fail_type == TRANSIENT_FAULT:
            self.stats.transient_faults += 1
        elif rec.status == "fail" and rec.fail_type == PERMANENT_FAULT:
            self.stats.permanent_faults += 1
        outcome = "demoted" if req.demoted else "completed"
        if req.demoted:
            self.stats.demoted += 1
        else:
            self.stats.completed += 1
        self.completions.append(
            Completion(id=req.id, outcome=outcome, record=rec, result=result, arrival_s=req.arrival_s, finish_s=finish)
        )

    def evacuate(self, now: Optional[float] = None) -> list:
        """Hand every queued request back to the caller (a router's
        failover or drain re-dispatch): the queue empties, each popped
        request counts as ``evacuated``. Returns the requests in
        (arrival, id) order."""
        out = list(self.queue)
        self.queue.clear()
        out.sort(key=lambda r: (r.arrival_s, r.id))
        self.stats.evacuated += len(out)
        return out

    def cancel(self, rid: int):
        """Remove one queued request before service (a hedge loser whose
        twin completed elsewhere), counted ``evacuated``. Returns the
        request, or None when it is not queued — and then nothing
        changes."""
        for req in self.queue:
            if req.id == rid:
                self.queue.remove(req)
                self.stats.evacuated += 1
                return req
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

    def _serve_one(self, req: ServeRequest):
        """(PipelineResult | None, TelemetryRecord) for one service
        attempt: real execution with typed-failure capture, or the modeled
        record of the discrete-event mode. A raised exception is
        classified along the transient/permanent axis, its text kept in
        ``record.extra["error"]``."""
        key = req.key
        if not self.execute:
            rec = self._modeled_record(req)
            self.engine.log.append(rec)
            return None, rec
        try:
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
            return result, result.record
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
            return None, rec

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
