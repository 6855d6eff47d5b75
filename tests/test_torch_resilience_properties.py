"""Property suite for the port's resilience layer under seeded fault
storms, after tests/test_resilience_properties.py. Each storm runs
through the port and the reference on the same draws, and the port is
held to the reference decision for decision, on one scheduler
(``simulate``) and on a fleet (``simulate_fleet``):

  * **conservation under faults**: every arrival reaches exactly one
    terminal outcome whatever the plan injects (transient storms, a
    poisoned signature, stragglers, stuck members), and on a fleet every
    replica's ledger balances, hedges and crash re-dispatches included;
  * **exactly-once under hedge races** (a fleet): hedge copies race on
    two replicas, crashes evacuate copies mid-race, and no ledger entry
    is ever served twice nor leaves a live twin queued;
  * **arrival-stamp preservation**: ``queue_wait_s + service_s ==
    finish - original arrival`` on every attempt record, across retries
    and, on a fleet, across crash re-dispatch;
  * **determinism**: one (code, seed) gives byte-identical summaries,
    on a fleet with hedging too;
  * **breaker trips mid-batch**: a poisoned signature tripping its
    breaker walks the ladder exactly as the reference's does, request by
    request (this port does not copy the reference's ``streaming/
    streaming > 0`` invariant, which does not hold for every draw).

Each ``_check_*`` body runs under hypothesis, derandomized and with no
example database (nothing is read from or written to
``.hypothesis/examples``), and under a pinned grid."""

import dataclasses
import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.serving import resilience as ref_res
from repro.serving import scheduler as ref_scheduler
from repro.serving import simulator as ref_sim
from repro_torch.serving import resilience as res
from repro_torch.serving import scheduler
from repro_torch.serving import simulator as sim

from test_torch_fleet import PORT, port_run, run_both, same_fleet, storm_cfg
from test_torch_resilience import _per_request, _ref_name, modeled_ref_engine, to_reference
from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)

#: the byte-model injection is one monkeypatch for every example, so the
#: function-scoped fixture is safe to share across them
SETTINGS = dict(max_examples=4, deadline=None, database=None, derandomize=True,
                suppress_health_check=[HealthCheck.function_scoped_fixture])
#: a fleet storm costs several single-scheduler ones
FLEET_SETTINGS = dict(SETTINGS, max_examples=2)


def _storm(mod, sched_mod, sim_mod, x, seed, rate, transient_rate, stuck_rate, poison=True, trip_after=3,
           cooldown_s=30.0, horizon_s=60.0, batched=False):
    """One scheduler under a seeded storm — tunable transient noise, an
    optionally poisoned signature, a straggler rule, rare stuck members —
    with retries, timeouts and the breaker on, built from one package's
    classes (``x`` is its name of the reference's ``xla``)."""
    rules = [mod.FaultRule(kind="transient", rate=transient_rate),
             mod.FaultRule(kind="straggler", rate=0.1, slow_factor=5.0)]
    if poison:
        rules.append(mod.FaultRule(kind="permanent", rate=1.0, executor_substr=x, shape=(32, 32, 32),
                                   precision="int8w"))
    if stuck_rate > 0:
        rules.append(mod.FaultRule(kind="stuck", rate=stuck_rate))
    return sim_mod.SimConfig(
        name="resilience-prop",
        seed=seed,
        horizon_s=horizon_s,
        process="poisson",
        process_kwargs={"rate_hz": rate},
        mix=sim_mod.STANDARD_MIX,
        scheduler=sched_mod.SchedulerConfig(
            max_queue_depth=32,
            admission_hbm_bytes=512 * 1024 * 1024,
            max_batch_requests=4,
            native_shapes=True,
            batched_dispatch=batched,
            classes={
                "interactive": sched_mod.PriorityClass("interactive", 0, deadline_s=None),
                "standard": sched_mod.PriorityClass("standard", 1, deadline_s=None),
                "batch": sched_mod.PriorityClass("batch", 2, deadline_s=None),
            },
        ),
        service=sim_mod.ServiceModel(base_s=0.05, batch_overhead_s=0.02),
        resilience=mod.ResiliencePolicy(
            retry=mod.RetryPolicy(max_attempts=3, backoff_base_s=0.05, seed=seed),
            service_timeout_s={"interactive": 2.0, "standard": 4.0, "batch": 8.0},
            breaker=mod.BreakerConfig(trip_after=trip_after, cooldown_s=cooldown_s),
        ),
        fault_plan=mod.FaultPlan(seed=seed, rules=tuple(rules)),
    )


def _both(models, **kw):
    """(port report, reference report) of one storm, the port's on the
    reference's byte models and bandwidths."""
    engine, _ = models
    cfg = _storm(res, scheduler, sim, "torch", **kw)
    cfg.service = dataclasses.replace(cfg.service, hbm_gbps=819.0, nvlink_gbps=90.0)
    got = sim.simulate(engine(), cfg)
    expect = ref_sim.simulate(modeled_ref_engine(), _storm(ref_res, ref_scheduler, ref_sim, "xla", **kw))
    return got, expect


def _same_decisions(got, expect):
    assert got.arrived == expect.arrived
    assert _per_request(got, _ref_name) == _per_request(expect, lambda e: e)
    assert json.dumps(to_reference(got.summary()), sort_keys=True) == json.dumps(expect.summary(), sort_keys=True)


# ------------------------------------------------------ invariant bodies ---


def _check_conservation_under_faults(models, seed, rate, transient_rate, stuck_rate, batched):
    got, expect = _both(models, seed=seed, rate=rate, transient_rate=transient_rate, stuck_rate=stuck_rate,
                        batched=batched)
    _same_decisions(got, expect)
    st_ = got.scheduler.stats
    assert st_.conserved(), st_
    req = got.summary()["requests"]
    assert req["arrived"] == req["refused"] + req["completed"] + req["demoted"] + sum(req["rejected"].values())
    ids = [c.id for c in got.completions]
    assert len(ids) == len(set(ids)) == st_.admitted


def _check_arrival_stamp_preserved(models, seed, rate, transient_rate):
    got, expect = _both(models, seed=seed, rate=rate, transient_rate=transient_rate, stuck_rate=0.0)
    _same_decisions(got, expect)
    arrival = {c.id: c.arrival_s for c in got.completions}
    for c in got.completions:
        if c.outcome in ("completed", "demoted"):
            rec = c.record
            assert rec.arrival_s == c.arrival_s
            assert rec.queue_wait_s + rec.service_s == pytest.approx(c.finish_s - c.arrival_s, abs=1e-9)
    for rec in got.scheduler.engine.log.records:
        if rec.attempt and rec.request_id is not None:
            assert rec.arrival_s == arrival[rec.request_id]


def _check_storm_determinism(models, seed, batched):
    engine, _ = models
    runs = [sim.simulate(engine(), _storm(res, scheduler, sim, "torch", seed=seed, rate=6.0, transient_rate=0.1,
                                          stuck_rate=0.002, batched=batched)).to_json() for _ in range(2)]
    assert runs[0] == runs[1]


def _check_breaker_trips_mid_batch(models, seed, rate):
    got, expect = _both(models, seed=seed, rate=rate, transient_rate=0.0, stuck_rate=0.0, trip_after=1,
                        cooldown_s=1e9, horizon_s=60.0)
    _same_decisions(got, expect)
    assert got.scheduler.stats.conserved()
    r = got.summary()["resilience"]
    if r["faults"]["permanent"] > 0:
        assert r["breaker"]["trips"] >= 1


def _check_fleet_conservation_under_faults(models, seed, rate, replicas, transient_rate, stuck_rate, hedge, crash_t):
    rep, expect = run_both(models, storm_cfg, seed, rate, replicas, transient_rate, stuck_rate, hedge=hedge,
                           crash_t=crash_t)
    same_fleet(rep, expect)
    fl = rep.fleet
    assert fl.conserved()
    for r in fl.replicas:
        assert r.sched.stats.conserved(), f"replica {r.id}: {r.sched.stats}"
    s = rep.summary()
    req = s["requests"]
    assert req["arrived"] == (req["refused"] + req["no_replica"] + req["completed"] + req["demoted"]
                              + sum(req["rejected"].values()))
    # admissions exceed unique admissions by the re-dispatches plus the
    # hedge copies
    assert req["admitted"] == (req["arrived"] - req["refused"] - req["no_replica"] + req["redispatched"]
                               + s["resilience"]["hedges"])


def _check_exactly_once_under_hedge_races(models, seed, rate, replicas, crash_t):
    rep, expect = run_both(models, storm_cfg, seed, rate, replicas, 0.1, 0.003, hedge=True, crash_t=crash_t)
    same_fleet(rep, expect)
    fl = rep.fleet
    assert all(e.completions_seen <= 1 for e in fl.ledger)
    served = [e for e in fl.ledger if e.outcome in ("completed", "demoted")]
    assert all(e.completions_seen == 1 for e in served)
    # served entries cancel their twins on the spot: no live queued copy
    for e in served:
        for (rid, lid) in e.copies:
            r = next((x for x in fl.replicas if x.id == rid), None)
            assert r is None or not r.live or all(q.id != lid for q in r.sched.queue)


def _check_fleet_arrival_stamp_preserved(models, seed, rate, replicas, transient_rate, crash_t):
    rep, expect = run_both(models, storm_cfg, seed, rate, replicas, transient_rate, 0.0, crash_t=crash_t)
    same_fleet(rep, expect)
    fl = rep.fleet
    arrival_of = {}
    for e in fl.ledger:
        if e.outcome in ("completed", "demoted"):
            rec = e.completion.record
            assert rec.arrival_s == e.arrival_s  # the original, not the re-submit time
            assert rec.queue_wait_s + rec.service_s == pytest.approx(e.finish_s - e.arrival_s, abs=1e-9)
            arrival_of[(rec.replica_id, rec.request_id)] = e.arrival_s
    for repl in fl.replicas:
        for rec in repl.sched.engine.log.records:
            key = (rec.replica_id, rec.request_id)
            if rec.attempt and rec.request_id is not None and key in arrival_of:
                assert rec.arrival_s == arrival_of[key]
    if crash_t is not None and replicas > 1:
        assert any(e.dispatches > 1 for e in fl.ledger) or fl.redispatched == 0


def _check_fleet_storm_determinism(models, seed, replicas, hedge, crash_t):
    runs = [port_run(models, storm_cfg(PORT, seed, 6.0, replicas, 0.1, 0.002, hedge=hedge, crash_t=crash_t))
            for _ in range(2)]
    assert runs[0].to_json() == runs[1].to_json()


# ------------------------------------------------- hypothesis exploration ---


@settings(**SETTINGS)
@given(
    seed=st.integers(0, 2**31 - 1),
    rate=st.floats(2.0, 8.0),
    transient_rate=st.floats(0.0, 0.3),
    stuck_rate=st.floats(0.0, 0.01),
    batched=st.booleans(),
)
def test_conservation_under_faults(reference_models, seed, rate, transient_rate, stuck_rate, batched):  # noqa: F811
    _check_conservation_under_faults(reference_models, seed, rate, transient_rate, stuck_rate, batched)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(2.0, 8.0), transient_rate=st.floats(0.05, 0.3))
def test_arrival_stamp_preserved(reference_models, seed, rate, transient_rate):  # noqa: F811
    _check_arrival_stamp_preserved(reference_models, seed, rate, transient_rate)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(2.0, 8.0))
def test_breaker_trips_mid_batch(reference_models, seed, rate):  # noqa: F811
    _check_breaker_trips_mid_batch(reference_models, seed, rate)


@settings(**FLEET_SETTINGS)
@given(
    seed=st.integers(0, 2**31 - 1),
    rate=st.floats(2.0, 10.0),
    replicas=st.integers(1, 4),
    transient_rate=st.floats(0.0, 0.3),
    stuck_rate=st.floats(0.0, 0.01),
    hedge=st.booleans(),
    crash_t=st.one_of(st.none(), st.floats(10.0, 60.0)),
)
def test_fleet_conservation_under_faults(reference_models, seed, rate, replicas, transient_rate, stuck_rate,  # noqa: F811
                                         hedge, crash_t):
    _check_fleet_conservation_under_faults(reference_models, seed, rate, replicas, transient_rate, stuck_rate, hedge,
                                           crash_t)


@settings(**FLEET_SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(4.0, 12.0), replicas=st.integers(2, 4),
       crash_t=st.one_of(st.none(), st.floats(10.0, 60.0)))
def test_exactly_once_under_hedge_races(reference_models, seed, rate, replicas, crash_t):  # noqa: F811
    _check_exactly_once_under_hedge_races(reference_models, seed, rate, replicas, crash_t)


@settings(**FLEET_SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(2.0, 8.0), replicas=st.integers(2, 4),
       transient_rate=st.floats(0.05, 0.3), crash_t=st.one_of(st.none(), st.floats(10.0, 60.0)))
def test_fleet_arrival_stamp_preserved(reference_models, seed, rate, replicas, transient_rate, crash_t):  # noqa: F811
    _check_fleet_arrival_stamp_preserved(reference_models, seed, rate, replicas, transient_rate, crash_t)


@settings(**FLEET_SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), replicas=st.integers(1, 3), hedge=st.booleans(),
       crash_t=st.one_of(st.none(), st.floats(10.0, 60.0)))
def test_fleet_storm_determinism(reference_models, seed, replicas, hedge, crash_t):  # noqa: F811
    _check_fleet_storm_determinism(reference_models, seed, replicas, hedge, crash_t)


# ------------------------------------------------- deterministic fallback ---


class TestGridFallback:
    """Pinned corners of the storm space, always run."""

    @pytest.mark.parametrize(
        "seed,rate,transient_rate,stuck_rate,batched",
        [(0, 4.0, 0.15, 0.0, False), (1, 8.0, 0.1, 0.005, True), (3, 6.0, 0.25, 0.01, False)],
    )
    def test_conservation_under_faults(self, reference_models, seed, rate, transient_rate, stuck_rate,  # noqa: F811
                                       batched):
        _check_conservation_under_faults(reference_models, seed, rate, transient_rate, stuck_rate, batched)

    @pytest.mark.parametrize("seed,rate,transient_rate", [(0, 4.0, 0.2), (1, 6.0, 0.1)])
    def test_arrival_stamp_preserved(self, reference_models, seed, rate, transient_rate):  # noqa: F811
        _check_arrival_stamp_preserved(reference_models, seed, rate, transient_rate)

    @pytest.mark.parametrize("seed,batched", [(0, False), (5, True)])
    def test_storm_determinism(self, reference_models, seed, batched):  # noqa: F811
        _check_storm_determinism(reference_models, seed, batched)

    @pytest.mark.parametrize("seed,rate", [(0, 4.0), (7, 6.0), (7765, 3.53125), (1560009467, 6.625)])
    def test_breaker_trips_mid_batch(self, reference_models, seed, rate):  # noqa: F811
        _check_breaker_trips_mid_batch(reference_models, seed, rate)

    @pytest.mark.parametrize(
        "seed,rate,replicas,transient_rate,stuck_rate,hedge,crash_t",
        [(1, 8.0, 3, 0.1, 0.005, True, 30.0), (3, 10.0, 2, 0.05, 0.01, False, 20.0)],
    )
    def test_fleet_conservation_under_faults(self, reference_models, seed, rate, replicas, transient_rate,  # noqa: F811
                                             stuck_rate, hedge, crash_t):
        _check_fleet_conservation_under_faults(reference_models, seed, rate, replicas, transient_rate, stuck_rate,
                                               hedge, crash_t)

    @pytest.mark.parametrize("seed,rate,replicas,crash_t", [(0, 8.0, 3, None), (2, 6.0, 4, 45.0)])
    def test_exactly_once_under_hedge_races(self, reference_models, seed, rate, replicas, crash_t):  # noqa: F811
        _check_exactly_once_under_hedge_races(reference_models, seed, rate, replicas, crash_t)

    @pytest.mark.parametrize("seed,rate,replicas,transient_rate,crash_t", [(0, 4.0, 2, 0.2, None), (1, 6.0, 3, 0.1, 30.0)])
    def test_fleet_arrival_stamp_preserved(self, reference_models, seed, rate, replicas, transient_rate,  # noqa: F811
                                           crash_t):
        _check_fleet_arrival_stamp_preserved(reference_models, seed, rate, replicas, transient_rate, crash_t)

    @pytest.mark.parametrize("seed,replicas,hedge,crash_t", [(0, 2, True, None), (5, 3, False, 25.0)])
    def test_fleet_storm_determinism(self, reference_models, seed, replicas, hedge, crash_t):  # noqa: F811
        _check_fleet_storm_determinism(reference_models, seed, replicas, hedge, crash_t)
