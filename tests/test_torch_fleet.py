"""The port's replicated fleet (serving/fleet.py) against the reference's,
after tests/test_fleet_golden.py and tests/test_system.py::TestFleetFaults.

1. The reference's goldens, ``tests/golden/fleet_*.json``, reproduced
   byte for byte by the port's ``simulate_fleet`` on
   ``reference_engine(device="cpu")``, with the reference's byte models,
   bandwidths and budget injected (``reference_models``) and its
   executor names in the cache payload (``reference_names``); the
   summary's rung and signature labels are mapped to the reference's
   names (``to_reference``).
2. The port's own goldens, ``tests/golden/torch_fleet_*.json``, under its
   defaults (``tools/write_serving_goldens.py`` writes them), and the
   reference's checks on what each golden must show. The fault-storm
   golden's tests are in tests/test_torch_resilience.py, as the
   reference's are in tests/test_resilience.py.
3. Decision-level parity: on a modeled trace of a few hundred arrivals
   under each router policy, with a crash event, each fid's replica,
   dispatches, outcome, hedges and completion fields equal the
   reference's.
4. Faults on the fleet: a replica whose pipeline raises, a router with
   every replica draining, the typed configuration errors; an executed
   fleet (the plain versions here) deciding as the modeled one does, and
   failover by ``crash_replica`` between dispatches.

The configuration functions here (``fleet_cfg``, ``storm_cfg``,
``cached_cfg``) build one package's configuration from its own classes;
the property suites import them.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from repro.serving import cache as ref_cache
from repro.serving import fleet as ref_fleet
from repro.serving import resilience as ref_res
from repro.serving import scheduler as ref_scheduler
from repro.serving import simulator as ref_sim
from repro_torch.core import meshnet, pipeline
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.data import mri
from repro_torch.serving import cache as cache_mod
from repro_torch.serving import fleet
from repro_torch.serving import resilience as res
from repro_torch.serving import scheduler
from repro_torch.serving import simulator as sim
from repro_torch.serving.engine import SegmentationEngine
from repro_torch.serving.errors import FleetConfigError, NoReplicaAvailable

from test_torch_resilience import _ref_name, modeled_ref_engine, reference_names, to_reference  # noqa: F401
from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with a test worker on every core, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FLEET_SCENARIOS = ["fleet_steady", "fleet_overload", "fleet_failover", "fleet_autoscale"]

#: each package's modules and its name of the reference's ``xla``
PORT = types.SimpleNamespace(fleet=fleet, sched=scheduler, sim=sim, res=res, cache=cache_mod, x="torch")
REF = types.SimpleNamespace(fleet=ref_fleet, sched=ref_scheduler, sim=ref_sim, res=ref_res, cache=ref_cache, x="xla")


def _load(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def _canonical(summary) -> str:
    return json.dumps(summary, sort_keys=True)


# ----------------------------------------------- configuration functions ---


def _classes(pkg, interactive=None, standard=None, batch=None):
    pc = pkg.sched.PriorityClass
    return {"interactive": pc("interactive", 0, deadline_s=interactive), "standard": pc("standard", 1, deadline_s=standard),
            "batch": pc("batch", 2, deadline_s=batch)}


def fleet_cfg(pkg, seed, rate, replicas, policy, crash_t=None, depth=16, drain_t=None, base_s=0.05):
    """tests/test_fleet_properties.py's ``_fleet_cfg`` from ``pkg``'s
    classes, with an optional drain event of replica 0 and a settable
    service base."""
    events = ()
    if crash_t is not None and replicas > 1:
        events = (pkg.fleet.FleetEvent(t=crash_t, action="crash", replica=replicas // 2),)
    if drain_t is not None:
        events = (pkg.fleet.FleetEvent(t=drain_t, action="drain", replica=0),)
    return pkg.fleet.FleetConfig(
        name="prop",
        seed=seed,
        horizon_s=60.0,
        process="poisson",
        process_kwargs={"rate_hz": rate},
        mix=pkg.sim.STANDARD_MIX,
        replicas=replicas,
        policy=policy,
        scheduler=pkg.sched.SchedulerConfig(max_queue_depth=depth, admission_hbm_bytes=4 * 1024 * 1024,
                                            max_batch_requests=4, native_shapes=True,
                                            classes=_classes(pkg, 5.0, 20.0, None)),
        service=pkg.fleet.FleetServiceModel(base_s=base_s, batch_overhead_s=0.02),
        events=events,
    )


def storm_cfg(pkg, seed, rate, replicas, transient_rate, stuck_rate, poison=True, hedge=False, crash_t=None,
              trip_after=3, cooldown_s=30.0, horizon_s=90.0):
    """tests/test_resilience_properties.py's ``_storm_cfg`` from ``pkg``'s
    classes: transient noise, a poisoned signature, a straggler replica,
    rare stuck members, retries, timeouts, a breaker and optional
    aggressive hedging."""
    m = pkg.res
    rules = [m.FaultRule(kind="transient", rate=transient_rate)]
    if poison:
        rules.append(m.FaultRule(kind="permanent", rate=1.0, executor_substr=pkg.x, shape=(32, 32, 32),
                                 precision="int8w"))
    if replicas > 1:
        rules.append(m.FaultRule(kind="straggler", rate=1.0, replica=replicas - 1, slow_factor=5.0))
    if stuck_rate > 0:
        rules.append(m.FaultRule(kind="stuck", rate=stuck_rate))
    events = ()
    if crash_t is not None and replicas > 1:
        events = (pkg.fleet.FleetEvent(t=crash_t, action="crash", replica=replicas // 2),)
    return pkg.fleet.FleetConfig(
        name="resilience-prop",
        seed=seed,
        horizon_s=horizon_s,
        process="poisson",
        process_kwargs={"rate_hz": rate},
        mix=pkg.sim.STANDARD_MIX,
        replicas=replicas,
        policy="cache_affinity",
        scheduler=pkg.sched.SchedulerConfig(max_queue_depth=32, admission_hbm_bytes=512 * 1024 * 1024,
                                            max_batch_requests=4, native_shapes=True, classes=_classes(pkg)),
        service=pkg.fleet.FleetServiceModel(base_s=0.05, batch_overhead_s=0.02),
        events=events,
        resilience=m.ResiliencePolicy(
            retry=m.RetryPolicy(max_attempts=3, backoff_base_s=0.05, seed=seed),
            service_timeout_s={"interactive": 2.0, "standard": 4.0, "batch": 8.0},
            hedge=m.HedgePolicy(p99_factor=1.0, min_age_s=0.05, min_samples=5, window=50, max_hedges=1)
            if hedge else None,
            breaker=m.BreakerConfig(trip_after=trip_after, cooldown_s=cooldown_s),
        ),
        fault_plan=m.FaultPlan(seed=seed, rules=tuple(rules)),
    )


def cached_cfg(pkg, seed, burst_hz, replicas, skew, universe, corrupt_rate=0.0, outage=None, slow_rate=0.0,
               capacity=2 * 1024 * 1024, horizon_s=240.0):
    """tests/test_cache_properties.py's ``_cached_cfg`` from ``pkg``'s
    classes: the shared tier under Zipf content and an optional
    cache-fault storm."""
    m = pkg.res
    rules = []
    if corrupt_rate > 0:
        rules.append(m.FaultRule(kind="corrupt_entry", rate=corrupt_rate))
    if outage is not None:
        rules.append(m.FaultRule(kind="cache_unavailable", rate=1.0, t0=outage[0], t1=outage[1]))
    if slow_rate > 0:
        rules.append(m.FaultRule(kind="slow_cache", rate=slow_rate, slow_factor=6.0))
    return pkg.fleet.FleetConfig(
        name="cache-prop",
        seed=seed,
        horizon_s=horizon_s,
        process="burst",
        process_kwargs={"base_hz": 2.0, "burst_hz": burst_hz, "period_s": 80.0, "burst_len_s": 12.0},
        mix=pkg.sim.STANDARD_MIX,
        replicas=replicas,
        policy="cache_affinity",
        scheduler=pkg.sched.SchedulerConfig(max_queue_depth=64, admission_hbm_bytes=512 * 1024 * 1024,
                                            max_batch_requests=8, native_shapes=True, classes=_classes(pkg)),
        service=pkg.fleet.FleetServiceModel(base_s=0.1, batch_overhead_s=0.05),
        cache=pkg.cache.CacheConfig(capacity_bytes=capacity, breaker_trip_after=3, breaker_cooldown_s=30.0),
        content_skew=skew,
        content_universe=universe,
        fault_plan=m.FaultPlan(seed=seed, rules=tuple(rules)) if rules else None,
    )


# ---------------------------------------------------------- running both ---


def port_run(models, cfg):
    """The port's fleet on the reference's byte models and bandwidths
    (``models`` is the ``reference_models`` fixture)."""
    engine, _ = models
    cfg.service = dataclasses.replace(cfg.service, hbm_gbps=819.0, nvlink_gbps=90.0)
    return fleet.simulate_fleet(cfg, engine)


def run_both(models, build, *args, **kw):
    """(port report, reference report) of ``build(pkg, *args, **kw)``."""
    got = port_run(models, build(PORT, *args, **kw))
    expect = ref_fleet.simulate_fleet(build(REF, *args, **kw), modeled_ref_engine)
    return got, expect


def per_fid(report, name_of):
    """Each ledger entry's routing and terminal fields, and its winning
    completion's record fields, in fid order."""
    out = []
    for e in report.fleet.ledger:
        c = e.completion
        done = None
        if c is not None:
            r = c.record
            done = (c.id, c.outcome, r.mode, name_of(r.executor), r.precision, r.status, r.fail_type, r.batch_size,
                    r.queue_wait_s, r.service_s, r.attempt, r.cache_hit, r.replica_id, r.arrival_s)
        out.append((e.fid, e.arrival_s, e.priority, e.replica, e.dispatches, e.outcome, e.finish_s, e.completions_seen,
                    e.hedges, done))
    return out


def same_fleet(got, expect):
    """The port's fleet decided as the reference's: every fid, and the
    summary after the executor-name map."""
    assert got.arrived == expect.arrived
    assert per_fid(got, _ref_name) == per_fid(expect, lambda e: e)
    assert _canonical(to_reference(got.summary())) == _canonical(expect.summary())


# ------------------------------------------------------------ the goldens ---


def test_presets_policies_and_defaults():
    assert fleet.FLEET_PRESETS == ref_fleet.FLEET_PRESETS
    assert fleet.ROUTER_POLICIES == ref_fleet.ROUTER_POLICIES
    model = fleet.FleetServiceModel()
    assert (model.hbm_gbps, model.nvlink_gbps, model.cold_compile_s) == (3350.0, 450.0, 0.25)
    assert dataclasses.asdict(fleet.AutoscalerConfig()) == dataclasses.asdict(ref_fleet.AutoscalerConfig())
    with pytest.raises(KeyError, match="unknown fleet preset"):
        fleet.fleet_preset("fleet_nope")


@pytest.mark.parametrize("name", FLEET_SCENARIOS + ["fleet_cached"])
def test_reference_golden_reproduced_byte_for_byte(reference_models, reference_names, name):  # noqa: F811
    fresh = to_reference(port_run(reference_models, fleet.fleet_preset(name, seed=0)).summary())
    assert _canonical(fresh) == _canonical(_load(name)), (
        f"fleet scenario {name!r} diverged from the reference's golden; fresh summary:\n"
        f"{json.dumps(fresh, indent=1, sort_keys=True)}"
    )


@pytest.mark.parametrize("name", FLEET_SCENARIOS + ["fleet_cached"])
def test_port_golden_matches(name):
    fresh = fleet.simulate_fleet(fleet.fleet_preset(name, seed=0), lambda: sim.reference_engine(device="cpu")).summary()
    assert _canonical(fresh) == _canonical(_load(f"torch_{name}")), (
        f"fleet scenario {name!r} diverged from the port's golden (tools/write_serving_goldens.py); fresh summary:\n"
        f"{json.dumps(fresh, indent=1, sort_keys=True)}"
    )


def _unique_terminal_total(req: dict) -> int:
    return req["refused"] + req["no_replica"] + req["completed"] + req["demoted"] + sum(req["rejected"].values())


@pytest.mark.parametrize("name", FLEET_SCENARIOS)
def test_port_goldens_conserve(name):
    golden = _load(f"torch_{name}")
    req = golden["requests"]
    assert req["conserved"] is True and req["served_twice"] == 0
    assert req["arrived"] == _unique_terminal_total(req)
    for rep in golden["per_replica"]:
        assert rep["admitted"] == rep["completed"] + rep["demoted"] + rep["rejected"] + rep["evacuated"]


def test_failover_golden_loses_nothing():
    golden = _load("torch_fleet_failover")
    req = golden["requests"]
    assert golden["replicas"]["crashed"] == 1
    crashes = [e for e in golden["scale_events"] if e["action"] == "crash"]
    assert len(crashes) == 1 and 120.0 < crashes[0]["t"] < 135.0
    assert req["evacuated"] > 0 and req["redispatched"] == req["evacuated"]
    assert req["served_twice"] == 0 and req["arrived"] == _unique_terminal_total(req)
    dead = [r for r in golden["per_replica"] if r["crashed"]]
    assert len(dead) == 1 and dead[0]["evacuated"] > 0


def test_autoscale_golden_scales_up_then_down():
    golden = _load("torch_fleet_autoscale")
    events = golden["scale_events"]
    adds = [e["t"] for e in events if e["action"] == "add"]
    drains = [e["t"] for e in events if e["action"] == "drain"]
    assert adds and drains and min(adds) < min(drains)
    assert golden["replicas"]["peak_routable"] > golden["replicas"]["initial"]
    assert golden["replicas"]["drained"] == len(drains)
    assert 1 <= golden["replicas"]["final_routable"] <= 6
    assert all(1 <= e["replicas_after"] <= 6 for e in events)


def test_fleet_overload_beats_the_single_server_golden():
    """The port's 4-replica overload fleet against the port's single
    server on the same storm: strictly fewer refusals and an interactive
    p99 under 5 virtual seconds."""
    fl, single = _load("torch_fleet_overload"), _load("torch_serving_overload")
    assert fl["process"] == single["process"] == "diurnal"
    assert fl["requests"]["arrived"] == single["requests"]["arrived"]
    assert single["requests"]["refused"] > 0
    assert fl["requests"]["refused"] < single["requests"]["refused"]
    assert fl["classes"]["interactive"]["latency_ms"]["p99"] < 5_000.0


def test_steady_golden_affinity_is_warm():
    golden = _load("torch_fleet_steady")
    aff = golden["affinity"]
    assert aff["policy"] == "cache_affinity" and aff["hit_rate"] > 0.8
    assert aff["cold_compiles"] < 3 * 5  # 5 signatures, compiled about once each
    assert golden["requests"]["refused"] == 0 and golden["requests"]["rejected"] == {}


class TestCachedGolden:
    """What the port's fleet_cached golden must show (the reference's
    TestCachedGolden on ``torch_fleet_cached.json``)."""

    def test_conserves_with_coalesced_fifth_state(self):
        golden = _load("torch_fleet_cached")
        req = golden["requests"]
        assert req["conserved"] is True and req["served_twice"] == 0
        assert req["arrived"] == _unique_terminal_total(req) + golden["cache"]["coalesced"]
        for rep in golden["per_replica"]:
            assert rep["admitted"] == (rep["completed"] + rep["demoted"] + rep["rejected"] + rep["evacuated"]
                                       + rep["coalesced"])

    def test_stampedes_actually_collapse(self):
        cache = _load("torch_fleet_cached")["cache"]
        assert cache["coalesced"] > 0 and cache["inflight_hits"] == cache["coalesced"]
        assert cache["content_routes"] > 0
        assert cache["served_from_cache"] == cache["admission_hits"] + cache["coalesced"]

    def test_corruption_is_quarantined_never_served(self):
        cache = _load("torch_fleet_cached")["cache"]
        assert cache["quarantined"] > 0 and cache["quarantined_served"] == 0

    def test_outage_fails_open_through_the_breaker(self):
        cache = _load("torch_fleet_cached")["cache"]
        assert cache["unavailable"] > 0 and cache["breaker_trips"] >= 1 and cache["breaker_skips"] > 0

    def test_skew_makes_the_cache_earn_its_bytes(self):
        golden = _load("torch_fleet_cached")
        cache = golden["cache"]
        assert cache["hit_rate"] > 0.3 and cache["evictions"] > 0
        assert cache["bytes_stored"] <= 2 * 1024 * 1024
        assert cache["served_from_cache"] > golden["requests"]["arrived"] / 3


# ------------------------------------------------------ decision parity ---


@pytest.mark.parametrize("policy", fleet.ROUTER_POLICIES)
def test_decisions_equal_the_references(reference_models, policy):  # noqa: F811
    """A 60-s trace of a few hundred arrivals on 3 replicas slow enough
    that queues build, replica 1 crashing at 25 s: every fid's replica,
    dispatches, outcome and completion fields equal the reference's."""
    got, expect = run_both(reference_models, fleet_cfg, 3, 8.0, 3, policy, crash_t=25.0, base_s=0.3)
    assert 200 <= got.arrived <= 700
    same_fleet(got, expect)
    assert got.fleet.redispatched > 0 and got.summary()["replicas"]["crashed"] == 1


def test_hedged_storm_decisions_equal_the_references(reference_models):  # noqa: F811
    """Hedging, retries, timeouts, the breaker and a crash on 3 replicas:
    every fid's hedges, dispatches, outcome and winning completion equal
    the reference's."""
    got, expect = run_both(reference_models, storm_cfg, 1, 8.0, 3, 0.1, 0.003, hedge=True, crash_t=30.0)
    same_fleet(got, expect)
    assert got.fleet.hedges > 0 and got.fleet.redispatched > 0


# --------------------------------------------------------- fleet faults ---

SMALL = MeshNetConfig(dilations=(1, 2, 4), channels=5)


def small_engine(executor="torch"):
    params = meshnet.init(SMALL, generator=torch.Generator().manual_seed(0), device="cpu")
    pc = PipelineConfig(model=SMALL, volume_shape=(16, 16, 16), cube=8, overlap=4, min_component_size=4,
                        executor=executor)
    return SegmentationEngine(params, pc, device="cpu")


def small_fleet(replicas=2, execute=False, **cfg_kwargs):
    return fleet.Fleet(fleet.FleetConfig(replicas=replicas, execute=execute, **cfg_kwargs), engine_factory=small_engine)


def volumes(n, shape=(16, 16, 16)):
    gen = torch.Generator().manual_seed(0)
    return [mri.generate(gen, mri.SyntheticMRIConfig(shape=shape), device="cpu")[0] for _ in range(n)]


def test_replica_raising_mid_batch_isolates_to_that_replica(monkeypatch):
    """A pipeline fault on one replica fails one request with a typed
    record; the other requests, on both replicas, complete, and the fleet
    conserves."""
    fl = small_fleet(replicas=2, execute=True, policy="round_robin")
    vols = volumes(4)
    poison = vols[1]
    real_run = pipeline.run

    def flaky_run(cfg, params, vol, **kw):
        if vol is poison:
            raise RuntimeError("injected replica fault")
        return real_run(cfg, params, vol, **kw)

    monkeypatch.setattr(pipeline, "run", flaky_run)
    for v in vols:
        fl.submit(v)
    fl.drain()
    assert fl.conserved()
    records = [e.completion.record for e in sorted(fl.ledger, key=lambda e: e.fid)]
    assert [r.status for r in records] == ["ok", "fail", "ok", "ok"]
    assert records[1].fail_type == "permanent_fault"
    assert "injected replica fault" in records[1].extra["error"]
    assert {r.replica_id for r in records} == {0, 1}


def test_router_with_all_replicas_draining_refuses_typed():
    fl = small_fleet(replicas=2)
    fl.drain_replica(0)
    fl.drain_replica(1)
    with pytest.raises(NoReplicaAvailable) as ei:
        fl.submit(np.zeros((16, 16, 16), np.float32))
    assert (ei.value.total, ei.value.draining, ei.value.crashed) == (2, 2, 0)
    assert fl.ledger[-1].outcome == "no_replica" and fl.no_replica == 1


def test_configuration_errors_are_typed():
    with pytest.raises(FleetConfigError, match="min_replicas"):
        fleet.Fleet(fleet.FleetConfig(replicas=1, autoscaler=fleet.AutoscalerConfig(min_replicas=0)),
                    engine_factory=small_engine)
    with pytest.raises(FleetConfigError, match=">= 1 replica"):
        fleet.Fleet(fleet.FleetConfig(replicas=0), engine_factory=small_engine)
    with pytest.raises(FleetConfigError, match="unknown router policy"):
        fleet.Fleet(fleet.FleetConfig(policy="random"), engine_factory=small_engine)
    fl = small_fleet(replicas=1)
    with pytest.raises(FleetConfigError, match="scale-to-zero"):
        fl.scale_down()
    assert fl.replicas[0].routable


def test_fleet_without_a_factory_is_on_the_card(monkeypatch):
    """``Fleet(cfg)`` builds ``reference_engine()`` replicas, which
    resolve to the card: without one it raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.Fleet(fleet.FleetConfig(replicas=1))


def test_replicas_share_no_engine_and_one_cache():
    fl = small_fleet(replicas=3, cache=cache_mod.CacheConfig())
    engines = [r.engine for r in fl.replicas]
    assert len({id(e) for e in engines}) == 3
    assert len({id(e.params["layers"][0]["w"]) for e in engines}) == 3
    assert all(r.sched.cache is fl.cache for r in fl.replicas) and fl.cache is not None
    assert [r.sched.replica_id for r in fl.replicas] == [0, 1, 2]


def test_a_crash_event_cannot_run_executed():
    """A crash event serves the replica's batch through
    ``run_batch_until`` with a finite horizon, which needs the modeled
    path: an executed fleet raises (as the reference's does)."""
    cfg = fleet.FleetConfig(replicas=2, execute=True, events=(fleet.FleetEvent(t=5.0, action="crash", replica=0),))
    fl = fleet.Fleet(cfg, engine_factory=small_engine)
    fl.submit(volumes(1)[0], arrival_s=0.0)
    with pytest.raises(ValueError, match="modeled path"):
        fl.drain()


def test_crash_between_dispatches_redispatches_exactly_once():
    """Failover on an executed fleet: with requests queued on replica 0,
    ``crash_replica(0)`` re-dispatches each once to replica 1, which
    serves it equal to ``submit``'s; then a drained replica takes no
    route and retires."""
    fl = small_fleet(replicas=2, execute=True, policy="round_robin")
    vols = volumes(4)
    fids = [fl.submit(v) for v in vols]
    queued0 = [e.fid for e in fl.ledger if e.replica == 0]
    assert len(queued0) == 2
    fl.crash_replica(0)
    assert fl.redispatched == 2 and all(fl.ledger[f].replica == 1 for f in queued0)
    fl.drain()
    assert fl.conserved()
    standalone = small_engine()
    for fid, v in zip(fids, vols):
        e = fl.ledger[fid]
        assert e.completions_seen == 1 and e.outcome == "completed" and e.completion.record.replica_id == 1
        assert e.dispatches == (2 if fid in queued0 else 1)
        rec = e.completion.record
        want = standalone.submit(v, mode=rec.mode, executor=rec.executor, precision=rec.precision)
        assert torch.equal(e.completion.result.segmentation, want.segmentation)
    fl = small_fleet(replicas=2, execute=True)
    fl.drain_replica(1)
    for v in vols[:2]:
        fl.submit(v)
    fl.drain()
    assert all(e.replica == 0 for e in fl.ledger) and fl.replicas[1].retired and fl.conserved()


def test_executed_fleet_decides_as_the_modeled_one(reference_models):  # noqa: F811
    """fleet_steady for 5 virtual seconds on replicas whose executor is
    ``cuda_fused`` (its plain version here): executed, every fid's
    replica, dispatches, outcome and finish time equal the modeled run's,
    and the modeled run's equal the reference's modeled run's. Both paths
    price service from the record's status and modeled bytes, so the
    executed path must stamp what the modeled one predicts."""
    engine, _ = reference_models

    def fused():
        eng = engine()
        eng.cfg = dataclasses.replace(eng.cfg, executor="cuda_fused")
        return eng

    runs = {}
    for execute in (True, False):
        cfg = fleet.fleet_preset("fleet_steady", horizon_s=5.0)
        cfg.execute = execute
        cfg.service = dataclasses.replace(cfg.service, hbm_gbps=819.0, nvlink_gbps=90.0)
        runs[execute] = fleet.simulate_fleet(cfg, fused)
    ref_cfg = ref_fleet.fleet_preset("fleet_steady", horizon_s=5.0)

    def ref_fused():
        eng = modeled_ref_engine()
        eng.cfg = dataclasses.replace(eng.cfg, executor="pallas_fused")
        return eng

    expect = ref_fleet.simulate_fleet(ref_cfg, ref_fused)

    def decisions(rep):
        return [(e.fid, e.replica, e.dispatches, e.outcome, e.finish_s) for e in rep.fleet.ledger]

    assert runs[True].arrived >= 5
    assert decisions(runs[True]) == decisions(runs[False]) == decisions(expect)
    recs = [e.completion.record for e in runs[True].fleet.ledger if e.completion.record.mode != "none"]
    assert recs and all(r.status == "ok" and r.executor == "cuda_fused" for r in recs)


def _two_waves(fl_mod, engine_factory, vol):
    fl = fl_mod.Fleet(fl_mod.FleetConfig(replicas=2), engine_factory=engine_factory)
    fl.submit(vol)
    fl.drain()
    fl.submit(vol)
    fl.drain()
    return fl


def test_a_second_drain_serves_the_second_wave(reference_models):  # noqa: F811
    """``drain`` after the clock has moved serves what was submitted since
    the last one: the port's loop starts at the clock's time. The
    reference's starts at 0.0, so its second drain finds the replicas busy
    "until" a time past the loop's ``now``, leaves the queue, and fails its
    own conservation assertion (ROADMAP.md, Queue 3, R7)."""
    engine, _ = reference_models
    stub = sim._ShapeStub((16, 16, 16))
    fl = _two_waves(fleet, engine, stub)
    assert fl.conserved() and [e.outcome for e in fl.ledger] == ["completed", "completed"]
    assert fl.ledger[1].finish_s > fl.ledger[0].finish_s
    with pytest.raises(AssertionError, match="conservation violated"):
        _two_waves(ref_fleet, modeled_ref_engine, ref_sim._ShapeStub((16, 16, 16)))
