"""Property suite for the port's artifact cache under seeded drives,
after tests/test_cache_properties.py, on one scheduler and on a fleet
sharing one cache tier. Each drive runs through the port and the
reference on the same draws:

  * **pinned in-flight never evicted**: under any op sequence on a
    byte-pressured store a pinned placeholder survives until its leader
    completes or abandons, the byte account equals the live entries'
    bytes after every op, and every answer and counter equals the
    reference store's;
  * **coalesced followers**: N identical concurrent requests give one
    execution and N-1 coalesced completions sharing the leader's
    checksum and status, as the reference's do;
  * **Zipf determinism**: ``zipf_content_id`` is the reference's draw for
    draw, pure in (seed, index); one seed gives byte-identical scheduler
    and fleet summaries with the cache, skew and a fault storm live;
  * **conservation under cache-fault storms**: corruption, outage windows
    and slow consults never lose a request, corrupt bytes are never
    served, and the summary equals the reference's, on one scheduler and
    (every fid equal the reference's) on a fleet.

Each ``_check_*`` body runs under hypothesis, derandomized and with no
example database, and under a pinned grid."""

import json
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.serving import cache as ref_cache
from repro.serving import resilience as ref_res
from repro.serving import scheduler as ref_scheduler
from repro.serving import simulator as ref_sim
from repro_torch.serving import cache as cache_mod
from repro_torch.serving import resilience as res
from repro_torch.serving import scheduler
from repro_torch.serving import simulator as sim

from test_torch_cache import PACKAGES, _drain_all, ok_record
from test_torch_fleet import PORT, cached_cfg, port_run, run_both, same_fleet
from test_torch_resilience import modeled_ref_engine, reference_names, to_reference  # noqa: F401  (fixture)
from test_torch_scheduler import make_sched, ref_sched, vol
from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)

#: the injections are one monkeypatch for every example, so the
#: function-scoped fixtures are safe to share across them
SETTINGS = dict(max_examples=5, deadline=None, database=None, derandomize=True,
                suppress_health_check=[HealthCheck.function_scoped_fixture])
#: a fleet storm costs several single-scheduler ones
FLEET_SETTINGS = dict(SETTINGS, max_examples=2)


def _cached_cfg(mod, cm, sched_mod, sim_mod, seed, burst_hz, skew, universe, corrupt_rate=0.0, outage=None,
                slow_rate=0.0, capacity=2 * 1024 * 1024, horizon_s=60.0):
    """One scheduler with the cache under Zipf content and an optional
    cache-fault storm, built from one package's classes."""
    rules = []
    if corrupt_rate > 0:
        rules.append(mod.FaultRule(kind="corrupt_entry", rate=corrupt_rate))
    if outage is not None:
        rules.append(mod.FaultRule(kind="cache_unavailable", rate=1.0, t0=outage[0], t1=outage[1]))
    if slow_rate > 0:
        rules.append(mod.FaultRule(kind="slow_cache", rate=slow_rate, slow_factor=6.0))
    return sim_mod.SimConfig(
        name="cache-prop",
        seed=seed,
        horizon_s=horizon_s,
        process="burst",
        process_kwargs={"base_hz": 2.0, "burst_hz": burst_hz, "period_s": 30.0, "burst_len_s": 6.0},
        mix=sim_mod.STANDARD_MIX,
        scheduler=sched_mod.SchedulerConfig(
            max_queue_depth=64,
            admission_hbm_bytes=512 * 1024 * 1024,
            max_batch_requests=8,
            native_shapes=True,
            classes={
                "interactive": sched_mod.PriorityClass("interactive", 0, deadline_s=None),
                "standard": sched_mod.PriorityClass("standard", 1, deadline_s=None),
                "batch": sched_mod.PriorityClass("batch", 2, deadline_s=None),
            },
        ),
        service=sim_mod.ServiceModel(base_s=0.1, batch_overhead_s=0.05),
        cache=cm.CacheConfig(capacity_bytes=capacity, breaker_trip_after=3, breaker_cooldown_s=30.0),
        content_skew=skew,
        content_universe=universe,
        fault_plan=mod.FaultPlan(seed=seed, rules=tuple(rules)) if rules else None,
    )


# ------------------------------------------------------ invariant bodies ---


def _check_pinned_never_evicted(seed, n_ops, capacity_entries):
    traces = []
    for name in ("port", "reference"):
        pkg = PACKAGES[name]
        cm = pkg[0]
        one = cm.artifact_bytes_modeled((8, 8, 8))
        cache = cm.ArtifactCache(cm.CacheConfig(capacity_bytes=capacity_entries * 2 * one))
        rng = random.Random(seed)
        pinned: set = set()
        trace = []
        t = 0.0
        for i in range(n_ops):
            t += 1.0
            key = f"k{rng.randrange(3 * capacity_entries)}"
            op = rng.choice(("begin", "complete", "lookup", "abandon"))
            if op == "begin":
                if key not in cache.inflight:
                    cache.begin(key, replica=0, now=t, est_bytes=one)
                    pinned.add(key)
            elif op == "complete" and key in pinned:
                trace.append(cache.complete(key, now=t, record=ok_record(pkg[2]), shape=(8, 8, 8)))
                pinned.discard(key)
            elif op == "abandon" and key in pinned:
                cache.abandon(key)
                pinned.discard(key)
            else:
                trace.append(cache.lookup(key, now=t, request_id=i).status)
            for p in pinned:
                assert p in cache.entries and cache.inflight_owner(p) == 0, f"pinned {p} evicted at op {i}"
            assert cache.stats.bytes_stored == sum(e.nbytes for e in cache.entries.values())
            trace.append(json.dumps(cache.summary(), sort_keys=True))
        assert cache.stats.quarantined_served == 0
        traces.append(trace)
    assert traces[0] == traces[1]


def _check_coalesced_followers(seed, n_followers):
    seen = []
    for sched, cm in ((make_sched(max_queue_depth=128), cache_mod), (ref_sched(max_queue_depth=128), ref_cache)):
        sched.cache = cm.ArtifactCache()
        v = vol(seed=seed)
        ids = [sched.submit(v.copy(), arrival_s=0.0) for _ in range(n_followers + 1)]
        assert len(sched.queue) == 1
        _drain_all(sched, now=1.0)
        comps = {c.id: c for c in sched.completions if c.id in ids}
        leader = next(c for c in comps.values() if c.outcome == "completed")
        for c in comps.values():
            assert c.record.status == leader.record.status
            assert c.record.extra["artifact_checksum"] == leader.record.extra["artifact_checksum"]
            assert c.record.cache_hit or c.outcome == "completed"
        assert sched.cache.stats.stores == 1 and sched.stats.conserved()
        seen.append((sorted((i, c.outcome, c.record.cache_hit) for i, c in comps.items()), sched.cache.summary()))
    assert seen[0] == seen[1]
    assert sorted(o for _, o, _ in seen[0][0]) == ["coalesced"] * n_followers + ["completed"]


def _check_zipf(seed, s, n, count):
    a = [sim.zipf_content_id(seed, i, s, n) for i in range(count)]
    assert a == [ref_sim.zipf_content_id(seed, i, s, n) for i in range(count)]
    assert a == [sim.zipf_content_id(seed, i, s, n) for i in range(count)]
    assert all(0 <= x < n for x in a)
    assert a != [sim.zipf_content_id(seed + 1, i, s, n) for i in range(count)]
    assert sum(1 for x in a if x == 0) >= sum(1 for x in a if x == n - 1)


def _check_conservation_under_cache_storm(models, seed, burst_hz, skew, corrupt_rate, outage):
    engine, _ = models
    kw = dict(seed=seed, burst_hz=burst_hz, skew=skew, universe=48, corrupt_rate=corrupt_rate, outage=outage,
              slow_rate=0.05, capacity=64 * 1024)
    cfg = _cached_cfg(res, cache_mod, scheduler, sim, **kw)
    cfg.service = sim.ServiceModel(base_s=0.1, batch_overhead_s=0.05, hbm_gbps=819.0, nvlink_gbps=90.0)
    got = sim.simulate(engine(), cfg)
    expect = ref_sim.simulate(modeled_ref_engine(), _cached_cfg(ref_res, ref_cache, ref_scheduler, ref_sim, **kw))
    s = got.summary()
    assert json.dumps(to_reference(s), sort_keys=True) == json.dumps(expect.summary(), sort_keys=True)
    assert got.scheduler.stats.conserved()
    req = s["requests"]
    assert req["arrived"] == (req["refused"] + req["completed"] + req["demoted"] + sum(req["rejected"].values())
                              + s["cache"]["coalesced"])
    assert s["cache"]["quarantined_served"] == 0
    if outage is not None:
        assert s["cache"]["unavailable"] > 0


def _check_same_seed_byte_identical(models, seed, skew):
    engine, _ = models
    runs = [sim.simulate(engine(), _cached_cfg(res, cache_mod, scheduler, sim, seed, 30.0, skew, 64,
                                               corrupt_rate=0.05, outage=(20.0, 35.0), slow_rate=0.02)).to_json()
            for _ in range(2)]
    assert runs[0] == runs[1]


def _check_fleet_conservation_under_cache_storm(models, seed, burst_hz, replicas, skew, corrupt_rate, outage):
    rep, expect = run_both(models, cached_cfg, seed, burst_hz, replicas, skew, 96, corrupt_rate=corrupt_rate,
                           outage=outage, capacity=512 * 1024, horizon_s=120.0)
    same_fleet(rep, expect)
    fl = rep.fleet
    assert fl.conserved()
    for r in fl.replicas:
        assert r.sched.stats.conserved(), f"replica {r.id}: {r.sched.stats}"
    s = rep.summary()
    req = s["requests"]
    assert req["arrived"] == (req["refused"] + req["no_replica"] + req["completed"] + req["demoted"]
                              + sum(req["rejected"].values()) + s["cache"]["coalesced"])
    assert s["cache"]["quarantined_served"] == 0
    if corrupt_rate > 0.02:
        assert s["cache"]["quarantined"] > 0
    if outage is not None:
        assert s["cache"]["unavailable"] > 0


def _check_same_seed_fleet_byte_identical(models, seed, replicas, skew):
    runs = [port_run(models, cached_cfg(PORT, seed, 30.0, replicas, skew, 128, corrupt_rate=0.05, outage=(60.0, 100.0),
                                        slow_rate=0.02, horizon_s=160.0)).to_json() for _ in range(2)]
    assert runs[0] == runs[1]


# ------------------------------------------------- hypothesis exploration ---


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), n_ops=st.integers(20, 120), capacity_entries=st.integers(1, 6))
def test_pinned_never_evicted(seed, n_ops, capacity_entries):
    _check_pinned_never_evicted(seed, n_ops, capacity_entries)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), n_followers=st.integers(1, 8))
def test_coalesced_followers(reference_names, seed, n_followers):  # noqa: F811
    _check_coalesced_followers(seed, n_followers)


@settings(**SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), s=st.floats(0.5, 2.0), n=st.integers(4, 512), count=st.integers(50, 300))
def test_zipf_determinism(seed, s, n, count):
    _check_zipf(seed, s, n, count)


@settings(**SETTINGS)
@given(
    seed=st.integers(0, 2**31 - 1),
    burst_hz=st.floats(10.0, 30.0),
    skew=st.floats(0.6, 1.6),
    corrupt_rate=st.floats(0.0, 0.2),
    outage=st.one_of(st.none(), st.tuples(st.floats(5.0, 30.0), st.floats(35.0, 55.0))),
)
def test_conservation_under_cache_storm(reference_models, reference_names, seed, burst_hz, skew,  # noqa: F811
                                        corrupt_rate, outage):
    _check_conservation_under_cache_storm(reference_models, seed, burst_hz, skew, corrupt_rate, outage)


@settings(**FLEET_SETTINGS)
@given(seed=st.integers(0, 2**31 - 1), replicas=st.integers(1, 3), skew=st.floats(0.8, 1.4))
def test_same_seed_fleet_byte_identical(reference_models, seed, replicas, skew):  # noqa: F811
    _check_same_seed_fleet_byte_identical(reference_models, seed, replicas, skew)


@settings(**FLEET_SETTINGS)
@given(
    seed=st.integers(0, 2**31 - 1),
    burst_hz=st.floats(10.0, 40.0),
    replicas=st.integers(1, 4),
    skew=st.floats(0.8, 1.5),
    corrupt_rate=st.floats(0.0, 0.1),
    outage=st.one_of(st.none(), st.just((60.0, 100.0))),
)
def test_fleet_conservation_under_cache_storm(reference_models, reference_names, seed, burst_hz, replicas,  # noqa: F811
                                              skew, corrupt_rate, outage):
    _check_fleet_conservation_under_cache_storm(reference_models, seed, burst_hz, replicas, skew, corrupt_rate, outage)


# ------------------------------------------------- deterministic fallback ---


class TestGridFallback:
    """Pinned corners of the property space, always run."""

    @pytest.mark.parametrize("seed,n_ops,capacity_entries", [(0, 120, 1), (1, 80, 3), (2, 100, 6)])
    def test_pinned_never_evicted(self, seed, n_ops, capacity_entries):
        _check_pinned_never_evicted(seed, n_ops, capacity_entries)

    @pytest.mark.parametrize("seed,n_followers", [(0, 1), (3, 7)])
    def test_coalesced_followers(self, reference_names, seed, n_followers):  # noqa: F811
        _check_coalesced_followers(seed, n_followers)

    @pytest.mark.parametrize("seed,s,n,count", [(0, 1.1, 256, 200), (1, 0.8, 16, 100), (2, 2.0, 64, 150)])
    def test_zipf_determinism(self, seed, s, n, count):
        _check_zipf(seed, s, n, count)

    @pytest.mark.parametrize(
        "seed,burst_hz,skew,corrupt_rate,outage",
        [(0, 20.0, 1.1, 0.1, None), (1, 30.0, 1.4, 0.05, (10.0, 40.0)), (2, 12.0, 0.8, 0.0, (20.0, 50.0))],
    )
    def test_conservation_under_cache_storm(self, reference_models, reference_names, seed, burst_hz,  # noqa: F811
                                            skew, corrupt_rate, outage):
        _check_conservation_under_cache_storm(reference_models, seed, burst_hz, skew, corrupt_rate, outage)

    @pytest.mark.parametrize("seed,skew", [(0, 1.1), (4, 0.9)])
    def test_same_seed_byte_identical(self, reference_models, seed, skew):  # noqa: F811
        _check_same_seed_byte_identical(reference_models, seed, skew)

    @pytest.mark.parametrize("seed,replicas,skew", [(0, 2, 1.1), (5, 3, 0.9)])
    def test_same_seed_fleet_byte_identical(self, reference_models, seed, replicas, skew):  # noqa: F811
        _check_same_seed_fleet_byte_identical(reference_models, seed, replicas, skew)

    @pytest.mark.parametrize(
        "seed,burst_hz,replicas,skew,corrupt_rate,outage",
        [(0, 30.0, 2, 1.1, 0.05, (60.0, 100.0)), (1, 40.0, 4, 1.3, 0.1, None)],
    )
    def test_fleet_conservation_under_cache_storm(self, reference_models, reference_names, seed, burst_hz,  # noqa: F811
                                                  replicas, skew, corrupt_rate, outage):
        _check_fleet_conservation_under_cache_storm(reference_models, seed, burst_hz, replicas, skew, corrupt_rate,
                                                    outage)
