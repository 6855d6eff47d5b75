"""Deterministic discrete-event load simulator for the serving scheduler
— counterpart of ``repro/serving/simulator.py``.

A seeded, virtual-clock traffic generator that drives ``RequestScheduler``
through the load shapes a segmentation service sees, so every latency,
throughput and shed-rate number is bit-reproducible on any host:

  * arrivals come from seeded processes on a *virtual* clock —
    ``poisson`` (steady traffic), ``burst`` (a quiet baseline with
    periodic request storms), ``diurnal`` (a thinned inhomogeneous
    Poisson ramp, the clinic-hours curve);
  * each arrival samples a **scenario mix** entry (shape, precision,
    device count, priority class, deliberately garbage volumes) from the
    same seeded generator;
  * service time is *modeled*, not measured: ``ServiceModel`` converts
    each request's modeled device-memory and collective bytes
    (telemetry/traffic.py) into virtual seconds at fixed bandwidths,
    with a per-batch dispatch overhead;
  * the event loop is single-server: batches serve back-to-back,
    arrivals landing mid-service queue behind them, deadlines expire on
    the virtual clock. No wall-clock value enters any decision or
    summary, even when ``execute=True`` runs the real pipeline.

``simulate`` returns a ``SimReport`` whose ``summary()`` dict (rounded,
key-sorted) is what the golden traces serialize: two runs with one seed
are byte-identical. ``tools/write_serving_goldens.py`` writes the port's.

``SimConfig.resilience`` and ``fault_plan`` put the resilience layer
(serving/resilience.py) behind the scheduler, ``cache`` the artifact
cache (serving/cache.py), and ``content_skew`` gives the modeled volumes
Zipf-distributed content identities (``zipf_content_id``). The summary
gains its ``resilience`` and ``cache`` blocks only when they are
configured, so the scenarios without them keep their goldens.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Optional

import numpy as np

from repro_torch.serving.cache import ArtifactCache, CacheConfig
from repro_torch.serving.resilience import unit_hash
from repro_torch.serving.scheduler import (
    Completion,
    PriorityClass,
    QueueFullError,
    RequestScheduler,
    SchedulerConfig,
)
from repro_torch.telemetry.analysis import nearest_rank


class VirtualClock:
    """A settable clock: ``now()`` is whatever the event loop last set.
    The scheduler only reads it, so scheduling decisions are pure
    functions of event times."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Virtual service time from modeled bytes, deterministic by
    construction:

        service_s = base + hbm_bytes / hbm_bw + collective_bytes / nvlink_bw

    and a failed request costs ``fail_s`` (admission work, no forward).
    ``batch_overhead_s`` is charged once per dispatch group.

    The bandwidths default to one NVIDIA H100 80GB HBM3 at 700 W, from its
    data sheet: 3.35e12 B/s of device memory (``hbm_gbps``) and NVLink's
    450 GB/s a direction (``nvlink_gbps``) for halo traffic between
    cards. ``base_s``, ``fail_s`` and ``batch_overhead_s`` are the
    scenario's abstract costs, the reference's, not measurements of any
    device. Under ``SchedulerConfig.batched_dispatch`` the scheduler
    evaluates ``service_s`` once per dispatch group, on a batch-N modeled
    record whose byte model streams the weights once.
    """

    hbm_gbps: float = 3350.0
    nvlink_gbps: float = 450.0
    base_s: float = 0.010
    fail_s: float = 0.002
    batch_overhead_s: float = 0.040

    def service_s(self, record) -> float:
        if record.status != "ok":
            return self.fail_s
        hbm = record.hbm_bytes_modeled or 0
        link = record.collective_bytes_modeled or 0
        return self.base_s + hbm / (self.hbm_gbps * 1e9) + link / (self.nvlink_gbps * 1e9)


# ------------------------------------------------------------- arrivals ---


def poisson_arrivals(rate_hz: float, horizon_s: float, rng: np.random.Generator):
    """Homogeneous Poisson process: exponential inter-arrival gaps."""
    t, out = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / rate_hz))
        if t >= horizon_s:
            return out
        out.append(t)


def burst_arrivals(
    base_hz: float,
    burst_hz: float,
    period_s: float,
    burst_len_s: float,
    horizon_s: float,
    rng: np.random.Generator,
):
    """Quiet Poisson baseline plus periodic storms: every ``period_s`` a
    window of ``burst_len_s`` runs at ``burst_hz`` on top of the base."""
    out = list(poisson_arrivals(base_hz, horizon_s, rng))
    start = 0.0
    while start < horizon_s:
        end = min(start + burst_len_s, horizon_s)
        t = start
        while True:
            t += float(rng.exponential(1.0 / burst_hz))
            if t >= end:
                break
            out.append(t)
        start += period_s
    return sorted(out)


def diurnal_arrivals(peak_hz: float, horizon_s: float, rng: np.random.Generator):
    """Inhomogeneous Poisson by thinning: the rate ramps 0 -> peak -> 0
    over the horizon."""
    out = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak_hz))
        if t >= horizon_s:
            return out
        accept = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / horizon_s))
        if float(rng.random()) < accept:
            out.append(t)


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "burst": burst_arrivals,
    "diurnal": diurnal_arrivals,
}


# -------------------------------------------------------- content skew ---

#: memoized Zipf CDFs keyed on (s, n) — the CDF is a pure function of
#: the distribution parameters, so sharing it across runs cannot couple
#: their draws (each draw's coin is an independent unit_hash).
_ZIPF_CDF_CACHE: dict = {}


def zipf_content_id(seed: int, index: int, s: float, n: int) -> int:
    """The ``index``-th arrival's content identity under a Zipf(s)
    popularity law over ``n`` distinct volumes — id 0 is the hottest.

    Deterministic: the uniform coin is ``unit_hash("zipf", seed, index)``
    (the counter-hash of serving/resilience.py), not a shared RNG stream,
    so other randomness in a scenario cannot perturb which content
    arrives when. Inverse CDF over the memoized normalized weights."""
    key = (float(s), int(n))
    cdf = _ZIPF_CDF_CACHE.get(key)
    if cdf is None:
        weights = [1.0 / (k ** float(s)) for k in range(1, int(n) + 1)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        _ZIPF_CDF_CACHE[key] = cdf
    u = unit_hash("zipf", seed, index)
    return min(bisect.bisect_left(cdf, u), int(n) - 1)


# ------------------------------------------------------------ scenarios ---


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One entry of the traffic mix: what an arriving request asks for.
    ``weight`` is its sampling probability mass; ``garbage=True`` ships a
    malformed volume (the fault lane — must fail typed, alone)."""

    shape: tuple = (16, 16, 16)
    mode: Optional[str] = None
    executor: Optional[str] = None
    devices: Optional[int] = None
    precision: Optional[str] = None
    priority: str = "standard"
    weight: float = 1.0
    garbage: bool = False


@dataclasses.dataclass
class SimConfig:
    """One simulator run: seeded arrivals over a scenario mix, through a
    scheduler configured for the experiment.

    ``resilience`` (a ``ResiliencePolicy``) and ``fault_plan`` (a
    ``FaultPlan``) configure the resilience layer; ``cache`` (a
    ``CacheConfig``, or an ``ArtifactCache`` to share) the artifact
    cache; ``content_skew`` is the Zipf exponent of request content over
    ``content_universe`` distinct volumes (None: no content identity).
    Only modeled (stub) volumes get identities. All None keeps a
    scenario's summary, and its golden, as without them."""

    name: str = "steady"
    seed: int = 0
    horizon_s: float = 600.0
    process: str = "poisson"
    process_kwargs: dict = dataclasses.field(default_factory=lambda: {"rate_hz": 0.5})
    mix: tuple = (ScenarioSpec(),)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    execute: bool = False
    service: ServiceModel = dataclasses.field(default_factory=ServiceModel)
    resilience: Optional[object] = None
    fault_plan: Optional[object] = None
    cache: Optional[object] = None
    content_skew: Optional[float] = None
    content_universe: int = 64


#: the outcomes that count as served in a summary
SERVED = ("completed", "demoted", "coalesced")


@dataclasses.dataclass
class SimReport:
    cfg: SimConfig
    scheduler: RequestScheduler
    completions: list
    arrived: int
    refused: int

    def summary(self) -> dict:
        """The deterministic rollup: counts, conservation, and per-class
        virtual-latency percentiles (nearest-rank; rounded to fixed
        decimals so serialization is byte-stable). This dict is the
        golden-trace payload."""
        st = self.scheduler.stats
        by_class: dict[str, list[Completion]] = {}
        for c in self.completions:
            by_class.setdefault(c.record.priority_class or "?", []).append(c)
        classes = {}
        for name in sorted(by_class):
            cs = by_class[name]
            served = [c for c in cs if c.outcome in SERVED]
            e2e = [c.finish_s - c.arrival_s for c in served]
            wait = [c.record.queue_wait_s or 0.0 for c in served]
            classes[name] = {
                "requests": len(cs),
                "served": len(served),
                "demoted": sum(1 for c in cs if c.outcome == "demoted"),
                "rejected": sum(1 for c in cs if c.outcome == "rejected"),
                "ok_rate": _round(sum(1 for c in served if c.record.status == "ok") / max(len(served), 1)),
                "latency_ms": _pctls_ms(e2e),
                "queue_wait_ms": _pctls_ms(wait),
            }
        served_all = [c for c in self.completions if c.outcome in SERVED]
        out = {
            "scenario": self.cfg.name,
            "seed": self.cfg.seed,
            "horizon_s": _round(self.cfg.horizon_s),
            "process": self.cfg.process,
            "requests": {
                "arrived": self.arrived,
                "refused": self.refused,
                "admitted": st.admitted,
                "completed": st.completed,
                "demoted": st.demoted,
                "rejected": dict(sorted(st.rejected.items())),
                "conserved": st.conserved(),
            },
            "batches": st.batches,
            "mean_batch_size": _round(len(served_all) / max(st.batches, 1)),
            "max_queue_depth": st.max_queue_depth,
            "throughput_rps": _round(len(served_all) / self.cfg.horizon_s),
            "latency_ms": _pctls_ms([c.finish_s - c.arrival_s for c in served_all]),
            "classes": classes,
        }
        # each block only when its layer is configured, so the scenarios
        # without it keep their summaries byte for byte
        if self.cfg.resilience is not None or self.cfg.fault_plan is not None:
            out["resilience"] = resilience_block(self.scheduler, served_all)
        if self.cfg.cache is not None:
            out["cache"] = cache_block(self.scheduler, served_all)
        return out

    def to_json(self) -> str:
        return json.dumps(self.summary(), indent=1, sort_keys=True)


def _round(x: float, nd: int = 4) -> float:
    return round(float(x), nd)


def _pctls_ms(values) -> dict:
    ms = [v * 1e3 for v in values]
    return {
        "p50": _round(nearest_rank(ms, 50)),
        "p99": _round(nearest_rank(ms, 99)),
        "mean": _round(sum(ms) / len(ms) if ms else 0.0),
        "max": _round(max(ms) if ms else 0.0),
    }


def resilience_block(sched, served) -> dict:
    """The deterministic resilience rollup of one scheduler: retry,
    fault and recovery counters, the breaker's state history, and the
    requests each rung (mode/executor) served — the degradation ladder
    made visible."""
    st = sched.stats
    rungs: dict[str, int] = {}
    for c in served:
        label = f"{c.record.mode}/{c.record.executor or '-'}"
        rungs[label] = rungs.get(label, 0) + 1
    br = sched.breaker
    return {
        "retries": st.retries,
        "faults": {
            "transient": st.transient_faults,
            "permanent": st.permanent_faults,
            "timeout": st.timeouts,
        },
        "faulted_requests": st.faulted_requests,
        "recovered_requests": st.recovered_requests,
        "recovery_rate": _round(st.recovered_requests / max(st.faulted_requests, 1)),
        "breaker": None
        if br is None
        else {
            "trips": br.trips,
            "restores": br.restores,
            "probes": br.probes,
            "open_signatures": br.open_signature_labels(),
            "transitions": br.transitions,
        },
        "rungs": dict(sorted(rungs.items())),
    }


def cache_block(sched, served) -> dict:
    """The deterministic artifact-cache rollup of one scheduler: the
    cache's own counters plus the scheduler's terminal cache accounting
    (admission hits, coalesced completions, served requests that never
    reached a device)."""
    st = sched.stats
    out = dict(sched.cache.summary()) if sched.cache is not None else {}
    out["admission_hits"] = st.cache_hits
    out["coalesced"] = st.coalesced
    out["served_from_cache"] = sum(1 for c in served if c.record.cache_hit)
    return out


def _sample_mix(mix, rng: np.random.Generator) -> ScenarioSpec:
    weights = np.array([s.weight for s in mix], dtype=np.float64)
    idx = int(rng.choice(len(mix), p=weights / weights.sum()))
    return mix[idx]


class _ShapeStub:
    """What an ``execute=False`` request carries instead of voxels: the
    modeled path reads only ``.shape``. ``content_id`` is the stub's
    content identity for the artifact cache: two stubs with equal (shape,
    content_id) stand for byte-equal volumes; None means no identity, and
    the cache consult bypasses the stub."""

    __slots__ = ("shape", "content_id")

    def __init__(self, shape, content_id=None):
        self.shape = tuple(shape)
        self.content_id = content_id


def _make_volume(spec: ScenarioSpec, rng: np.random.Generator, execute: bool):
    """A cheap deterministic volume (numpy; the simulator load-tests the
    scheduler, not the segmenter), or a shape-only stub when nothing will
    execute. Garbage specs ship a 1-D payload the pipeline cannot
    conform — the typed-failure lane."""
    if spec.garbage:
        return np.zeros((3,), np.float32) if execute else _ShapeStub((3,))
    if not execute:
        return _ShapeStub(spec.shape)
    return rng.random(spec.shape, dtype=np.float32)


def simulate(engine, cfg: SimConfig) -> SimReport:
    """Drive ``engine`` through one simulated load trace. Single-server
    discrete-event loop: deliver arrivals up to the clock, dispatch the
    next admission group, advance the clock by its modeled service, shed
    whatever expired meanwhile — until both the trace and the queue are
    empty."""
    rng = np.random.default_rng(cfg.seed)
    proc = ARRIVAL_PROCESSES[cfg.process]
    times = proc(horizon_s=cfg.horizon_s, rng=rng, **cfg.process_kwargs)
    arrivals = [(t, _sample_mix(cfg.mix, rng)) for t in times]
    # volumes drawn after the whole arrival and mix sequence, so that
    # payloads never perturb arrival sampling (stubs skip the draws)
    vols = [_make_volume(spec, rng, cfg.execute) for _, spec in arrivals]
    if cfg.content_skew is not None:
        # content identities are per-index counter-hash draws, not the
        # shared rng, so skew cannot perturb the sequences above; garbage
        # volumes stay identity-less
        for idx, ((_, spec), v) in enumerate(zip(arrivals, vols)):
            if isinstance(v, _ShapeStub) and not spec.garbage:
                v.content_id = zipf_content_id(cfg.seed, idx, cfg.content_skew, cfg.content_universe)
    cache = None
    if cfg.cache is not None:
        cache = (
            cfg.cache
            if isinstance(cfg.cache, ArtifactCache)
            else ArtifactCache(cfg.cache if isinstance(cfg.cache, CacheConfig) else None, fault_plan=cfg.fault_plan)
        )
    clock = VirtualClock()
    sched = RequestScheduler(
        engine,
        cfg.scheduler,
        clock=clock,
        service_model=cfg.service,
        execute=cfg.execute,
        resilience=cfg.resilience,
        fault_plan=cfg.fault_plan,
        cache=cache,
    )
    i = 0
    refused = 0
    n = len(arrivals)
    while i < n or sched.has_work():
        if not sched.has_work():
            # idle: jump to the next arrival
            clock.advance_to(arrivals[i][0])
        # deliver everything that has arrived by now
        while i < n and arrivals[i][0] <= clock.now():
            t, spec = arrivals[i]
            try:
                sched.submit(
                    vols[i],
                    priority=spec.priority,
                    mode=spec.mode,
                    executor=spec.executor,
                    devices=spec.devices,
                    precision=spec.precision,
                    arrival_s=t,
                )
            except QueueFullError:
                refused += 1
            i += 1
        batch = sched.next_batch(now=clock.now())
        if batch is None:
            wake = sched.next_ready_s(clock.now())
            if wake is not None:
                # every queued request is gated: advance to whichever
                # comes first, the next arrival or the earliest wake
                if i < n and arrivals[i][0] < wake:
                    clock.advance_to(arrivals[i][0])
                else:
                    clock.advance_to(wake)
            continue  # else: everything queued just expired; next arrival
        finish = sched.run_batch(batch)
        clock.advance_to(finish)
    completions = sorted(sched.completions, key=lambda c: c.id)
    assert sched.stats.conserved(), f"conservation violated: {sched.stats}"
    return SimReport(cfg=cfg, scheduler=sched, completions=completions, arrived=n, refused=refused)


def reference_engine(device=None):
    """The canonical engine the traces are generated against: a tiny
    configuration (the simulator load-tests the scheduler, not the
    kernels) — ``MeshNetConfig()`` at 16^3, sub-volume cube 8 with overlap
    4, ``min_component_size`` 4, executor ``auto`` (``torch`` on the CPU,
    the reference's ``xla``; ``cuda_fused`` on the card), weights from
    ``meshnet.init`` with seed 0. On the card unless the caller asks for
    the CPU (``device="cpu"``). The modeled path never reads the
    weights."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import meshnet
    from repro_torch.core.meshnet import MeshNetConfig
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.serving.engine import SegmentationEngine

    dev = resolve_device(device)
    cfg = MeshNetConfig()
    params = meshnet.init(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    pc = PipelineConfig(
        model=cfg,
        volume_shape=(16, 16, 16),
        cube=8,
        overlap=4,
        min_component_size=4,
        executor="auto",
    )
    return SegmentationEngine(params, pc, device=dev)


# ------------------------------------------------------- scenario presets ---

#: heterogeneous mix of every preset: two shapes, two storage policies,
#: all three priority classes, and a garbage lane.
STANDARD_MIX = (
    ScenarioSpec(shape=(16, 16, 16), priority="interactive", weight=3.0),
    ScenarioSpec(shape=(16, 16, 16), precision="bf16", priority="standard", weight=3.0),
    ScenarioSpec(shape=(32, 32, 32), precision="int8w", priority="standard", weight=2.0),
    # the fp32 heavyweight lane: ~1.7 MiB streaming working set — the one
    # the overload preset's 1 MiB admission budget demotes to the failsafe
    ScenarioSpec(shape=(32, 32, 32), priority="standard", weight=1.0),
    ScenarioSpec(shape=(32, 32, 32), mode="subvolume", priority="batch", weight=1.5),
    ScenarioSpec(shape=(16, 16, 16), garbage=True, priority="standard", weight=0.5),
)


def preset(name: str, seed: int = 0, horizon_s: Optional[float] = None) -> SimConfig:
    """The three load scenarios (golden traces):

    ``steady``   — Poisson arrivals well under capacity: the queue stays
                   shallow, nothing sheds; the latency floor.
    ``burst``    — quiet baseline with 20x request storms: queues spike,
                   deadlines hold, grouping absorbs most of it.
    ``overload`` — sustained arrivals beyond service capacity into a
                   short queue with a tight admission budget: the
                   scheduler must shed via typed rejection and demotion,
                   and conservation must still hold.

    Any preset also exists as ``<name>_batched``: the same trace with
    ``SchedulerConfig.batched_dispatch=True``.
    """
    if name.endswith("_batched"):
        cfg = preset(name[: -len("_batched")], seed=seed, horizon_s=horizon_s)
        cfg.name = name
        cfg.scheduler = dataclasses.replace(cfg.scheduler, batched_dispatch=True)
        return cfg
    if name == "steady":
        return SimConfig(
            name="steady",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            process="poisson",
            process_kwargs={"rate_hz": 0.5},
            mix=STANDARD_MIX,
            scheduler=SchedulerConfig(
                max_queue_depth=64,
                admission_hbm_bytes=512 * 1024 * 1024,
                max_batch_requests=8,
                native_shapes=True,
            ),
        )
    if name == "burst":
        return SimConfig(
            name="burst",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            process="burst",
            process_kwargs={
                "base_hz": 0.2,
                "burst_hz": 20.0,
                "period_s": 120.0,
                "burst_len_s": 15.0,
            },
            mix=STANDARD_MIX,
            scheduler=SchedulerConfig(
                max_queue_depth=64,
                admission_hbm_bytes=512 * 1024 * 1024,
                max_batch_requests=8,
                native_shapes=True,
            ),
        )
    if name == "overload":
        return SimConfig(
            name="overload",
            seed=seed,
            horizon_s=horizon_s or 600.0,
            # the diurnal ramp's midday peak runs past service capacity
            # (slower service model below), so the scheduler must shed:
            # queue-full refusals, expired deadlines and sub-volume
            # demotions, with conservation still exact
            process="diurnal",
            process_kwargs={"peak_hz": 12.0},
            mix=STANDARD_MIX,
            scheduler=SchedulerConfig(
                max_queue_depth=32,
                # tight: a 32^3 fp32 streaming working set (~1.7 MiB) does
                # not fit -> those requests demote to the failsafe
                admission_hbm_bytes=1 * 1024 * 1024,
                max_batch_requests=8,
                native_shapes=True,
                # deadlines tighter than the default ladder, so that expiry
                # shedding is exercised too
                classes={
                    "interactive": PriorityClass("interactive", 0, deadline_s=10.0),
                    "standard": PriorityClass("standard", 1, deadline_s=2.5),
                    "batch": PriorityClass("batch", 2, deadline_s=30.0),
                },
            ),
            service=ServiceModel(base_s=0.1, batch_overhead_s=0.05),
        )
    raise KeyError(f"unknown scenario preset {name!r}: steady | burst | overload")


PRESETS = ("steady", "burst", "overload")
