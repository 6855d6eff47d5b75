"""Property suite for the port's replicated fleet (serving/fleet.py),
after tests/test_fleet_properties.py. Each drive runs through the port's
``simulate_fleet`` and the reference's on the same draws, and the port is
held to the reference fid for fid (``test_torch_fleet.same_fleet``)
before the reference's invariant is checked on the port's result:

  * **fleet conservation**: summed over replicas (crashes and drains
    included), admitted == completed + demoted + rejected + evacuated,
    and every arrival has exactly one terminal ledger outcome;
  * **exactly-once**: after failover re-dispatch no request is served
    twice (``completions_seen <= 1`` on every ledger entry);
  * **router hygiene**: no policy routes to a draining or dead replica,
    cache affinity included;
  * **determinism**: one seed gives byte-identical fleet summaries,
    across replica counts, policies and crash events;
  * the per-replica rollup (``telemetry.analysis.replica_summary``)
    rebuilds each replica's ledger from its records alone.

Each ``_check_*`` body runs under hypothesis, derandomized and with no
example database, and under a pinned grid."""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.serving import fleet as ref_fleet
from repro_torch.serving import fleet
from repro_torch.telemetry.analysis import replica_summary

from test_torch_fleet import PORT, REF, fleet_cfg, modeled_ref_engine, port_run, run_both, same_fleet
from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)

#: the byte-model injection is one monkeypatch for every example, so the
#: function-scoped fixture is safe to share across them
SETTINGS = dict(max_examples=2, deadline=None, database=None, derandomize=True,
                suppress_health_check=[HealthCheck.function_scoped_fixture])


# ------------------------------------------------------ invariant bodies ---


def _check_fleet_conservation(models, seed, rate, replicas, policy, crash_t):
    rep, expect = run_both(models, fleet_cfg, seed, rate, replicas, policy, crash_t)
    same_fleet(rep, expect)
    fl = rep.fleet
    assert fl.conserved()
    for r in fl.replicas:
        assert r.sched.stats.conserved(), f"replica {r.id}: {r.sched.stats}"
        if r.crashed:
            assert not r.sched.queue, "crashed replica retained queued work"
    req = rep.summary()["requests"]
    unique_terminal = req["refused"] + req["no_replica"] + req["completed"] + req["demoted"] + sum(
        req["rejected"].values())
    assert req["arrived"] == unique_terminal
    # per-replica admissions exceed unique admissions by exactly the
    # re-dispatches
    assert req["admitted"] == req["arrived"] - req["refused"] - req["no_replica"] + req["redispatched"]


def _check_no_request_served_twice(models, seed, rate, replicas, crash_t):
    rep, expect = run_both(models, fleet_cfg, seed, rate, replicas, "cache_affinity", crash_t)
    same_fleet(rep, expect)
    fl = rep.fleet
    assert all(e.completions_seen <= 1 for e in fl.ledger)
    served = [e for e in fl.ledger if e.outcome in ("completed", "demoted")]
    assert all(e.completions_seen == 1 for e in served)
    assert len(served) == sum(r.sched.stats.completed + r.sched.stats.demoted for r in fl.replicas)


def _check_router_avoids_draining(models, seed, rate, replicas, policy):
    """No routing decision, under any policy, lands on a draining or dead
    replica; instrumented at the port's router."""
    chosen = []
    orig = fleet.Fleet._pick

    def recording(self, *a, **kw):
        r = orig(self, *a, **kw)
        chosen.append((r.id, r.draining, r.crashed))
        return r

    fleet.Fleet._pick = recording
    try:
        rep = port_run(models, fleet_cfg(PORT, seed, rate, replicas, policy, drain_t=20.0))
    finally:
        fleet.Fleet._pick = orig
    expect = ref_fleet.simulate_fleet(fleet_cfg(REF, seed, rate, replicas, policy, drain_t=20.0), modeled_ref_engine)
    same_fleet(rep, expect)
    assert chosen and all(not draining and not crashed for _, draining, crashed in chosen)
    assert rep.summary()["replicas"]["drained"] == 1


def _check_fleet_determinism(models, seed, replicas, policy, crash_t):
    runs = [port_run(models, fleet_cfg(PORT, seed, 6.0, replicas, policy, crash_t)) for _ in range(2)]
    assert runs[0].to_json() == runs[1].to_json()
    same_fleet(runs[0], ref_fleet.simulate_fleet(fleet_cfg(REF, seed, 6.0, replicas, policy, crash_t),
                                                 modeled_ref_engine))


def test_replica_summary_rollup(reference_models):  # noqa: F811
    """Fleet telemetry is replica-stamped, and the per-replica rollup
    rebuilds each replica's ledger from the record stream alone."""
    rep = port_run(reference_models, fleet_cfg(PORT, 0, 6.0, 3, "cache_affinity", 25.0))
    fl = rep.fleet
    records = [r for repl in fl.replicas for r in repl.sched.engine.log.records]
    by_id = {r.replica_id: r for r in replica_summary(records)}
    for repl in fl.replicas:
        st_ = repl.sched.stats
        if st_.completed + st_.demoted + st_.rejected_total() == 0:
            assert repl.id not in by_id
            continue
        row = by_id[repl.id]
        assert row.served == st_.completed + st_.demoted and row.demoted == st_.demoted
        assert sum(row.shed.values()) == st_.rejected_total()
    # re-dispatched requests are stamped with the replica that served them
    assert sum(r.served for r in by_id.values()) == sum(1 for e in fl.ledger if e.outcome in ("completed", "demoted"))


# ------------------------------------------------- hypothesis exploration ---


@settings(**SETTINGS)
@given(
    seed=st.integers(0, 2**31 - 1),
    rate=st.floats(1.0, 10.0),
    replicas=st.integers(1, 5),
    policy=st.sampled_from(fleet.ROUTER_POLICIES),
    crash_t=st.one_of(st.none(), st.floats(5.0, 50.0)),
)
def test_fleet_conservation(reference_models, seed, rate, replicas, policy, crash_t):  # noqa: F811
    _check_fleet_conservation(reference_models, seed, rate, replicas, policy, crash_t)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(4.0, 12.0), replicas=st.integers(2, 5),
       crash_t=st.floats(5.0, 50.0))
def test_no_request_served_twice(reference_models, seed, rate, replicas, crash_t):  # noqa: F811
    _check_no_request_served_twice(reference_models, seed, rate, replicas, crash_t)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(1.0, 8.0), replicas=st.integers(2, 5),
       policy=st.sampled_from(fleet.ROUTER_POLICIES))
def test_router_avoids_draining(reference_models, seed, rate, replicas, policy):  # noqa: F811
    _check_router_avoids_draining(reference_models, seed, rate, replicas, policy)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), replicas=st.integers(1, 4), policy=st.sampled_from(fleet.ROUTER_POLICIES),
       crash_t=st.one_of(st.none(), st.floats(10.0, 40.0)))
def test_fleet_determinism(reference_models, seed, replicas, policy, crash_t):  # noqa: F811
    _check_fleet_determinism(reference_models, seed, replicas, policy, crash_t)


# ------------------------------------------------- deterministic fallback ---


class TestGridFallback:
    """Pinned corners of the fleet property space, always run (from the
    reference's grid)."""

    @pytest.mark.parametrize(
        "seed,rate,replicas,policy,crash_t",
        [(1, 8.0, 3, "cache_affinity", 25.0), (3, 10.0, 5, "join_shortest_queue", 12.0)],
    )
    def test_fleet_conservation(self, reference_models, seed, rate, replicas, policy, crash_t):  # noqa: F811
        _check_fleet_conservation(reference_models, seed, rate, replicas, policy, crash_t)

    @pytest.mark.parametrize("seed,rate,replicas,crash_t", [(0, 8.0, 3, 20.0), (1, 12.0, 2, 35.0)])
    def test_no_request_served_twice(self, reference_models, seed, rate, replicas, crash_t):  # noqa: F811
        _check_no_request_served_twice(reference_models, seed, rate, replicas, crash_t)

    @pytest.mark.parametrize("seed,rate,replicas,policy", [(0, 4.0, 2, "cache_affinity"), (1, 6.0, 4, "round_robin")])
    def test_router_avoids_draining(self, reference_models, seed, rate, replicas, policy):  # noqa: F811
        _check_router_avoids_draining(reference_models, seed, rate, replicas, policy)

    @pytest.mark.parametrize("seed,replicas,policy,crash_t",
                             [(0, 3, "cache_affinity", 20.0), (5, 2, "join_shortest_queue", None)])
    def test_fleet_determinism(self, reference_models, seed, replicas, policy, crash_t):  # noqa: F811
        _check_fleet_determinism(reference_models, seed, replicas, policy, crash_t)
