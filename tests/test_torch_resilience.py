"""The port's resilience layer (serving/resilience.py and its threading
through serving/scheduler.py and serving/simulator.py) against the
reference's, after tests/test_resilience.py.

  * policy objects: ``unit_hash`` draws, backoff values, the
    validations, the breaker's state, rung and transition log over the
    same result sequences, ``FaultPlan.decide`` / ``decide_cache`` over a
    grid of identities, and ``demote_rung`` walks mapped through
    ``executors.reference_name``;
  * the simulator: ``simulate`` on ``reference_engine(device="cpu")``
    with the reference's byte models injected (``reference_models``, as
    the serving golden test does) under a resilience policy with a
    transient/permanent fault plan, a stuck rule with timeouts on every
    class, and a ``_batched`` preset with faults: the summaries equal the
    reference's after the executor-name map (``to_reference``);
  * the scheduler: on a modeled trace of a few hundred arrivals with
    resilience and the cache on, each request's outcome, attempt, fail
    type, executor rung, ``cache_hit`` and finish time equal the
    reference's;
  * the fleet's fault storm (serving/fleet.py, ``fleet_faultstorm``): the
    reference's golden reproduced byte for byte under its byte models and
    names, the port's golden (``tests/golden/torch_fleet_faultstorm.json``)
    and what it must show, and its determinism."""

import collections
import dataclasses
import functools
import json
import os
import types

import pytest
import torch

from repro.serving import cache as ref_cache
from repro.serving import resilience as ref_res
from repro.serving import scheduler as ref_scheduler
from repro.serving import simulator as ref_sim
from repro.serving.errors import ResilienceConfigError as RefResilienceConfigError
from repro_torch.core import executors
from repro_torch.serving import cache as cache_mod
from repro_torch.serving import fleet
from repro_torch.serving import resilience as res
from repro_torch.serving import scheduler
from repro_torch.serving import simulator as sim
from repro_torch.serving.errors import SERVICE_TIMEOUT, ResilienceConfigError
from repro_torch.telemetry.analysis import resilience_summary

from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)

Key = collections.namedtuple("Key", "mode executor devices precision shape")


def _key(executor="xla", mode="streaming", precision="fp32", shape=(32, 32, 32)):
    return Key(mode=mode, executor=executor, devices=None, precision=precision, shape=shape)


# ------------------------------------------- the executor-name map ---


def _ref_label(label: str) -> str:
    """A "mode/executor[/...]" label with the port's executor name mapped
    to the reference's (names that are not the port's stay)."""
    parts = label.split("/")
    try:
        parts[1] = executors.reference_name(parts[1])
    except KeyError:
        pass
    return "/".join(parts)


def to_reference(summary: dict) -> dict:
    """A port summary with every executor name mapped to the reference's:
    the resilience block's rung labels (counts of labels that meet are
    summed), open signatures and transition signatures. Nothing is
    dropped."""
    out = json.loads(json.dumps(summary))
    block = out.get("resilience")
    if block is not None:
        rungs: dict = {}
        for label, n in block["rungs"].items():
            rungs[_ref_label(label)] = rungs.get(_ref_label(label), 0) + n
        block["rungs"] = dict(sorted(rungs.items()))
        br = block["breaker"]
        if br is not None:
            br["open_signatures"] = sorted(_ref_label(s) for s in br["open_signatures"])
            for tr in br["transitions"]:
                tr["signature"] = _ref_label(tr["signature"])
    return out


@pytest.fixture
def reference_names(monkeypatch):
    """The cache's artifact payload with the reference's executor name,
    for the duration of a test: the payload's JSON length enters each
    entry's byte account ("torch" is 5 characters, "xla" 3), so the byte
    counts and the eviction order match the reference's only under its
    names. The scheduler's own records keep the port's."""
    complete = cache_mod.ArtifactCache.complete

    def with_reference_name(self, key, *, record, **kw):
        if record.executor is not None:
            record = dataclasses.replace(record, executor=executors.reference_name(record.executor))
        return complete(self, key, record=record, **kw)

    monkeypatch.setattr(cache_mod.ArtifactCache, "complete", with_reference_name)


def _canonical(summary) -> str:
    return json.dumps(summary, sort_keys=True)


def modeled_ref_engine():
    """The reference's ``reference_engine()`` configuration without its
    weights: the modeled path (``execute=False``) reads only the engine's
    configuration, and the weights' jax init costs seconds."""
    from repro.core.meshnet import MeshNetConfig
    from repro.core.pipeline import PipelineConfig
    from repro.serving.engine import SegmentationEngine

    pc = PipelineConfig(model=MeshNetConfig(), volume_shape=(16, 16, 16), cube=8, overlap=4, min_component_size=4,
                        executor="xla")
    return SegmentationEngine(None, pc)


@pytest.fixture
def ref_engine():
    return modeled_ref_engine()


def simulate_both(reference_models, ref_engine, name, make, horizon_s=60.0, seed=0):  # noqa: F811
    """(port report, port summary mapped to the reference's names,
    reference summary) of one preset with the fields ``make(module, cache
    module, executor name)`` returns, built from each package's own
    classes."""
    engine, preset = reference_models
    cfg = preset(name, seed=seed, horizon_s=horizon_s)
    for field, value in make(res, cache_mod, "torch").items():
        setattr(cfg, field, value)
    got = sim.simulate(engine(), cfg)
    ref_cfg = ref_sim.preset(name, seed=seed, horizon_s=horizon_s)
    for field, value in make(ref_res, ref_cache, "xla").items():
        setattr(ref_cfg, field, value)
    expect = ref_sim.simulate(ref_engine, ref_cfg)
    return got, to_reference(got.summary()), expect.summary()


# --------------------------------------------------------- policy objects ---


def test_ladder_is_the_references_under_the_ports_names():
    assert tuple(executors.reference_name(n) for n in res.LADDER) == ref_res.LADDER
    assert (res.FAULT_KINDS, res.CACHE_FAULT_KINDS) == (ref_res.FAULT_KINDS, ref_res.CACHE_FAULT_KINDS)


def test_unit_hash_draws_equal_the_references():
    parts = [("fault", s, r, rep, q, a) for s in (0, 7) for r in range(3) for rep in (0, 2) for q in (0, 5, 999)
             for a in (0, 1)]
    parts += [("zipf", 3, i) for i in range(50)] + [("backoff", 1, 0, 4, 2), ("a",), ("cachefault", 0, 1, 0, 9, "lookup")]
    got = [res.unit_hash(*p) for p in parts]
    assert got == [ref_res.unit_hash(*p) for p in parts]
    assert all(0.0 <= u < 1.0 for u in got) and 0.4 < sum(got) / len(got) < 0.6


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(max_attempts=6, backoff_base_s=0.1, backoff_mult=2.0, backoff_max_s=0.4, jitter_frac=0.0),
        dict(backoff_base_s=1.0, backoff_mult=1.0, backoff_max_s=1.0, jitter_frac=0.25, seed=7),
        dict(),
    ],
)
def test_backoff_values_equal_the_references(kwargs):
    port, ref = res.RetryPolicy(**kwargs), ref_res.RetryPolicy(**kwargs)
    grid = [(a, rep, rid) for a in range(1, 7) for rep in (0, 3) for rid in range(40)]
    assert [port.backoff_s(*g) for g in grid] == [ref.backoff_s(*g) for g in grid]


@pytest.mark.parametrize(
    "cls,kwargs",
    [
        ("RetryPolicy", {"max_attempts": 0}),
        ("RetryPolicy", {"backoff_mult": 0.0}),
        ("RetryPolicy", {"backoff_base_s": -1.0}),
        ("RetryPolicy", {"jitter_frac": 1.0}),
        ("RetryPolicy", {"jitter_frac": -0.1}),
        ("HedgePolicy", {"p99_factor": 0.0}),
        ("HedgePolicy", {"max_hedges": 0}),
        ("BreakerConfig", {"trip_after": 0}),
        ("BreakerConfig", {"cooldown_s": -1.0}),
        ("FaultRule", {"kind": "gremlin"}),
        ("FaultRule", {"kind": "transient", "rate": 1.5}),
        ("FaultRule", {"kind": "straggler", "slow_factor": 0.5}),
    ],
)
def test_configs_refuse_what_the_references_refuse(cls, kwargs):
    with pytest.raises(RefResilienceConfigError):
        getattr(ref_res, cls)(**kwargs)
    with pytest.raises(ResilienceConfigError):
        getattr(res, cls)(**kwargs)
    assert issubclass(ResilienceConfigError, ValueError)


#: breaker drives: (trip_after, cooldown_s, steps); a step is ("result",
#: fault, probe, now), ("peek", now) or ("claim", now)
BREAKER_DRIVES = {
    "consecutive_only": (3, 10.0, [("result", True, False, 1.0), ("result", True, False, 2.0),
                                   ("result", False, False, 3.0), ("result", True, False, 4.0),
                                   ("result", True, False, 5.0), ("peek", 5.0), ("result", True, False, 6.0),
                                   ("peek", 6.0)]),
    "half_open_restores_or_reopens": (1, 10.0, [("result", True, False, 0.0), ("claim", 5.0), ("claim", 10.0),
                                                ("claim", 10.0), ("result", True, True, 11.0), ("claim", 15.0),
                                                ("claim", 21.0), ("result", False, True, 22.0), ("claim", 23.0)]),
    "peek_claims_nothing": (1, 1.0, [("result", True, False, 0.0), ("peek", 2.0), ("peek", 2.0), ("claim", 2.0),
                                     ("peek", 2.0)]),
    "ladder_walk": (1, 1e9, [("result", True, False, float(i)) for i in range(4)] + [("peek", 5.0)]),
}


@pytest.mark.parametrize("drive", sorted(BREAKER_DRIVES))
def test_breaker_state_rung_and_log_equal_the_references(drive):
    trip_after, cooldown, steps = BREAKER_DRIVES[drive]
    k = _key()
    seen = []
    for mod in (res, ref_res):
        br = mod.SignatureBreaker(mod.BreakerConfig(trip_after=trip_after, cooldown_s=cooldown))
        trace = []
        for step in steps:
            if step[0] == "result":
                br.on_result(k, fault=step[1], probe=step[2], now=step[3])
                trace.append(None)
            elif step[0] == "peek":
                trace.append(br.peek_rung(k, step[1]))
            else:
                trace.append(br.effective_rung(k, step[1]))
            e = br.entries.get(k)
            trace.append(None if e is None else dataclasses.astuple(e))
        seen.append((trace, br.transitions, br.trips, br.restores, br.probes, br.open_signature_labels()))
    assert seen[0] == seen[1]


@pytest.mark.parametrize(
    "start",
    ["cuda_megakernel", "cuda_fused", "torch", "streaming", "sharded_cuda_megakernel@2", "sharded_torch@4"],
)
@pytest.mark.parametrize("mode", ["full", "streaming"])
def test_demote_rung_walks_equal_the_references(ref_engine, start, mode):
    """From each rung, the port's walk down the ladder, its executor names
    mapped through ``reference_name``, is the reference's walk from the
    mapped rung: executor rungs first, then one mode demotion."""
    engine = sim.reference_engine(device="cpu")
    work = (engine.cfg.cube + 2 * engine.cfg.overlap,) * 3
    walks = []
    for eng, mod, group_key, name in (
        (engine, res, scheduler.GroupKey, start),
        (ref_engine, ref_res, ref_scheduler.GroupKey, executors.reference_name(start)),
    ):
        key = group_key(mode=mode, executor=name, devices=None, precision="fp32", shape=work)
        walk = []
        while key is not None:
            walk.append((key.mode, key.executor))
            key = mod.demote_rung(key, eng)
        walks.append(walk)
    got, expect = walks
    assert [(m, executors.reference_name(e)) for m, e in got] == expect
    assert [m for m, _ in got].count("subvolume") == 1 and got[-1][0] == "subvolume"


@pytest.mark.parametrize(
    "start, walk",
    [
        ("cuda_megakernel", ["cuda_megakernel", "cuda_fused", "subvolume/cuda_fused"]),
        ("cuda_fused", ["cuda_fused", "subvolume/cuda_fused"]),
        ("sharded_cuda_megakernel@2", ["sharded_cuda_megakernel@2", "sharded_cuda_fused@2", "subvolume/cuda_fused"]),
        ("torch", ["torch", "subvolume/torch"]),
    ],
)
def test_demote_rung_on_the_card_never_reaches_a_plain_forward(start, walk):
    """On a CUDA device the ladder is ``CARD_LADDER``: from a kernel's rung
    the walk goes on to the sub-volume failsafe under cuda_fused and
    stops, never onto the plain forwards (torch, streaming), so a kernel
    that keeps failing is not routed around. A request that asked for
    the plain forward keeps it. Resolving these names touches no card."""
    engine = sim.reference_engine(device="cpu")
    card = types.SimpleNamespace(device=torch.device("cuda"), cfg=engine.cfg)
    work = (engine.cfg.cube + 2 * engine.cfg.overlap,) * 3
    key = scheduler.GroupKey(mode="full", executor=start, devices=None, precision="fp32", shape=work)
    got = []
    while key is not None:
        got.append(key.executor if key.mode == "full" else f"{key.mode}/{key.executor}")
        key = res.demote_rung(key, card)
    assert got == walk
    assert res.CARD_LADDER == tuple(r for r in res.LADDER if r.startswith("cuda_"))


FAULT_PLANS = {
    "first_match": lambda m, x: m.FaultPlan(seed=3, rules=(m.FaultRule(kind="permanent", rate=1.0, executor_substr=x),
                                                          m.FaultRule(kind="transient", rate=1.0))),
    "window_and_coin": lambda m, x: m.FaultPlan(seed=0, rules=(m.FaultRule(kind="transient", rate=0.5, t0=10.0,
                                                                           t1=20.0),)),
    "every_kind": lambda m, x: m.FaultPlan(seed=11, rules=(
        m.FaultRule(kind="straggler", rate=0.3, replica=1, slow_factor=5.0),
        m.FaultRule(kind="stuck", rate=0.1, priority="batch"),
        m.FaultRule(kind="permanent", rate=0.2, shape=(32, 32, 32), precision="int8w"),
        m.FaultRule(kind="corrupt_entry", rate=0.4),
        m.FaultRule(kind="cache_unavailable", rate=0.2, t0=5.0, t1=15.0),
        m.FaultRule(kind="slow_cache", rate=0.3, slow_factor=6.0),
        m.FaultRule(kind="transient", rate=0.25, mode="streaming"),
    )),
}


@pytest.mark.parametrize("plan", sorted(FAULT_PLANS))
def test_fault_decisions_equal_the_references_draw_for_draw(plan):
    port, ref = FAULT_PLANS[plan](res, "torch"), FAULT_PLANS[plan](ref_res, "xla")
    keys = [(_key("torch"), _key("xla")), (_key("streaming"), _key("streaming")),
            (_key("torch", precision="int8w"), _key("xla", precision="int8w")),
            (_key("cuda_fused", mode="subvolume"), _key("pallas_fused", mode="subvolume")), (None, None)]
    for t in (1.0, 12.0, 25.0):
        for replica in (0, 1):
            for pk, rk in keys:
                for rid in range(0, 60, 7):
                    for prio in (None, "batch"):
                        for attempt in (0, 1, 2):
                            if pk is not None:
                                got = port.decide(t=t, replica=replica, key=pk, request_id=rid, attempt=attempt,
                                                  priority=prio)
                                expect = ref.decide(t=t, replica=replica, key=rk, request_id=rid, attempt=attempt,
                                                    priority=prio)
                                assert (got and dataclasses.astuple(got)) == (expect and dataclasses.astuple(expect))
                    for op in ("lookup", "store"):
                        got = port.decide_cache(t=t, replica=replica, key=pk, request_id=rid, op=op)
                        expect = ref.decide_cache(t=t, replica=replica, key=rk, request_id=rid, op=op)
                        assert (got and dataclasses.astuple(got)) == (expect and dataclasses.astuple(expect))
    assert (port.has_stuck(), port.has_cache_rules()) == (ref.has_stuck(), ref.has_cache_rules())


# ------------------------------------------------------------ the simulator ---


def test_stuck_faults_require_timeouts_everywhere(ref_engine):
    for mod, s, eng in ((res, sim, sim.reference_engine(device="cpu")), (ref_res, ref_sim, ref_engine)):
        cfg = s.SimConfig(
            horizon_s=30.0,
            fault_plan=mod.FaultPlan(seed=0, rules=(mod.FaultRule(kind="stuck", rate=0.01),)),
            resilience=mod.ResiliencePolicy(service_timeout_s={"interactive": 5.0}),
        )
        with pytest.raises(ValueError, match="stuck"):
            s.simulate(eng, cfg)
    with pytest.raises(ResilienceConfigError, match="stuck"):
        scheduler.RequestScheduler(sim.reference_engine(device="cpu"),
                                   fault_plan=res.FaultPlan(rules=(res.FaultRule(kind="stuck"),)))


SIM_CASES = {
    # a policy with the breaker, a transient storm and a poisoned
    # signature whose window closes (so its probe restores it)
    "transient_and_permanent": ("steady", lambda m, c, x: dict(
        resilience=m.ResiliencePolicy(retry=m.RetryPolicy(max_attempts=3, seed=0),
                                      breaker=m.BreakerConfig(trip_after=2, cooldown_s=10.0)),
        fault_plan=m.FaultPlan(seed=0, rules=(
            m.FaultRule(kind="transient", rate=0.2),
            m.FaultRule(kind="permanent", rate=1.0, executor_substr=x, shape=(32, 32, 32), precision="int8w",
                        t1=30.0))))),
    "stuck_with_timeouts": ("steady", lambda m, c, x: dict(
        resilience=m.ResiliencePolicy(retry=m.RetryPolicy(max_attempts=3, seed=0),
                                      service_timeout_s={"interactive": 5.0, "standard": 5.0, "batch": 5.0},
                                      breaker=None),
        fault_plan=m.FaultPlan(seed=0, rules=(m.FaultRule(kind="stuck", rate=0.1),)))),
    "batched_with_faults": ("steady_batched", lambda m, c, x: dict(
        resilience=m.ResiliencePolicy(retry=m.RetryPolicy(max_attempts=3, seed=0),
                                      service_timeout_s={"interactive": 5.0, "standard": 5.0, "batch": 5.0}),
        fault_plan=m.FaultPlan(seed=0, rules=(
            m.FaultRule(kind="transient", rate=0.2),
            m.FaultRule(kind="straggler", rate=0.2, slow_factor=3.0),
            m.FaultRule(kind="stuck", rate=0.05))))),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulator_summary_equals_the_references(reference_models, ref_engine, case):  # noqa: F811
    name, make = SIM_CASES[case]
    rep, got, expect = simulate_both(reference_models, ref_engine, name, make)
    assert _canonical(got) == _canonical(expect)
    r = got["resilience"]
    assert got["requests"]["conserved"] and sum(r["faults"].values()) > 0
    if case == "stuck_with_timeouts":
        timed = [rec for rec in rep.scheduler.engine.log.records if rec.fail_type == SERVICE_TIMEOUT]
        assert timed and all(rec.service_s == 5.0 for rec in timed)
    if case == "transient_and_permanent":
        assert r["breaker"]["trips"] >= 1 and r["retries"] > 0
    # the attempt stream alone reproduces the scheduler's own counters
    rs = resilience_summary(rep.scheduler.engine.log.records)
    assert (rs.retries, rs.faulted_requests, rs.recovered_requests) == (
        r["retries"], r["faulted_requests"], r["recovered_requests"])


def test_breaker_half_open_probe_restores_after_window(reference_models, ref_engine):  # noqa: F811
    """The reference's restore scenario: a poisoned signature trips, its
    fault window closes, a half-open probe restores the fast path."""
    rep, got, expect = simulate_both(reference_models, ref_engine, "steady", lambda m, c, x: dict(
        resilience=m.ResiliencePolicy(retry=m.RetryPolicy(max_attempts=2, seed=0),
                                      breaker=m.BreakerConfig(trip_after=3, cooldown_s=60.0)),
        fault_plan=m.FaultPlan(seed=0, rules=(m.FaultRule(kind="permanent", rate=1.0, executor_substr=x,
                                                          shape=(32, 32, 32), precision="int8w", t1=120.0),))),
        horizon_s=600.0)
    assert _canonical(got) == _canonical(expect)
    br = got["resilience"]["breaker"]
    assert br["trips"] >= 1 and br["probes"] >= 1 and br["restores"] >= 1 and br["open_signatures"] == []
    assert "streaming/streaming" in got["resilience"]["rungs"]


def test_plain_run_has_no_resilience_block():
    rep = sim.simulate(sim.reference_engine(device="cpu"), sim.preset("steady", horizon_s=60.0))
    assert "resilience" not in rep.summary() and "cache" not in rep.summary()


# ------------------------------------------------------------- the scheduler ---


def _per_request(rep, name_of):
    out = []
    for c in rep.completions:
        r = c.record
        out.append((c.id, c.outcome, r.attempt, r.fail_type, r.mode, name_of(r.executor), r.cache_hit,
                    c.finish_s))
    return out


def _ref_name(e):
    """The reference's name of a port executor; None (a garbage request)
    and a name the reference-name injection already mapped stay."""
    try:
        return e if e is None else executors.reference_name(e)
    except KeyError:
        return e


def _storm(m, c, x, extra_rules=()):
    """SimConfig fields of a fault storm with retries, timeouts, the
    breaker and the cache under Zipf content, from resilience module
    ``m``, cache module ``c`` and executor name ``x``."""
    return dict(
        resilience=m.ResiliencePolicy(retry=m.RetryPolicy(max_attempts=3, seed=1),
                                      service_timeout_s={"interactive": 4.0, "standard": 4.0, "batch": 8.0},
                                      breaker=m.BreakerConfig(trip_after=2, cooldown_s=30.0)),
        fault_plan=m.FaultPlan(seed=1, rules=(
            m.FaultRule(kind="transient", rate=0.15),
            m.FaultRule(kind="permanent", rate=1.0, executor_substr=x, shape=(32, 32, 32), precision="int8w",
                        t0=100.0, t1=250.0),
            m.FaultRule(kind="stuck", rate=0.02),
            m.FaultRule(kind="corrupt_entry", rate=0.1),
            m.FaultRule(kind="slow_cache", rate=0.1),
            *(m.FaultRule(**r) for r in extra_rules))),
        cache=c.CacheConfig(capacity_bytes=150_000, negative_ttl_s=60.0),
        content_skew=1.1,
        content_universe=24,
    )


def _storm_reports(reference_models, ref_engine, extra_rules=()):  # noqa: F811
    """(port report, reference report) of a 600-s steady trace under
    ``_storm``."""
    engine, preset = reference_models
    cfg = preset("steady", seed=2)
    for field, value in _storm(res, cache_mod, "torch", extra_rules).items():
        setattr(cfg, field, value)
    rep = sim.simulate(engine(), cfg)
    ref_cfg = ref_sim.preset("steady", seed=2)
    for field, value in _storm(ref_res, ref_cache, "xla", extra_rules).items():
        setattr(ref_cfg, field, value)
    return rep, ref_sim.simulate(ref_engine, ref_cfg)


def test_scheduler_decisions_equal_the_references(reference_models, reference_names, ref_engine):  # noqa: F811
    """A 600-s steady trace with retries, timeouts, the breaker, a fault
    storm and the cache under Zipf content: every request's outcome,
    attempt, fail type, rung, cache_hit and finish time equal the
    reference's."""
    rep, ref_rep = _storm_reports(reference_models, ref_engine)
    assert rep.arrived == ref_rep.arrived and 200 <= rep.arrived <= 600
    assert _per_request(rep, _ref_name) == _per_request(ref_rep, lambda e: e)
    assert _canonical(to_reference(rep.summary())) == _canonical(ref_rep.summary())
    outcomes = {c.outcome for c in rep.completions}
    assert {"completed", "coalesced"} <= outcomes
    assert any(c.record.attempt > 0 for c in rep.completions)
    assert rep.summary()["cache"]["quarantined"] > 0 and rep.summary()["cache"]["quarantined_served"] == 0


def test_scheduler_decisions_on_a_nonzero_replica_equal_the_references(
    reference_models, reference_names, ref_engine, monkeypatch  # noqa: F811
):
    """The same storm served by ``RequestScheduler(replica_id=3)`` in both
    packages, with one more transient rule pinned to replica 3 and one to
    replica 0: the replica keys the fault coins, the backoff jitter and
    the cache's leader ownership, so every request's outcome, attempt,
    fail type, rung, cache_hit and finish time still equal the
    reference's, and they differ from replica 0's."""
    extra = ({"kind": "transient", "rate": 0.3, "replica": 3}, {"kind": "permanent", "rate": 1.0, "replica": 0})
    base, _ = _storm_reports(reference_models, ref_engine, extra)
    for mod in (sim, ref_sim):
        monkeypatch.setattr(mod, "RequestScheduler", functools.partial(mod.RequestScheduler, replica_id=3))
    rep, ref_rep = _storm_reports(reference_models, ref_engine, extra)
    assert _per_request(rep, _ref_name) == _per_request(ref_rep, lambda e: e)
    assert _canonical(to_reference(rep.summary())) == _canonical(ref_rep.summary())
    assert _per_request(rep, _ref_name) != _per_request(base, _ref_name)

    def rules(report):
        return {r.extra.get("rule") for r in report.scheduler.engine.log.records if "injected" in r.extra}

    assert 5 in rules(rep) and 6 not in rules(rep)
    assert 5 not in rules(base)


# ------------------------------------------------ the fleet's fault storm ---


def _fleet_faultstorm(engine):
    cfg = fleet.fleet_preset("fleet_faultstorm", seed=0)
    return cfg, lambda: fleet.simulate_fleet(cfg, engine).summary()


def _golden(name):
    with open(os.path.join(os.path.dirname(__file__), "golden", f"{name}.json")) as f:
        return json.load(f)


def test_faultstorm_golden_trace_matches(reference_models, reference_names):  # noqa: F811
    """The reference's fleet_faultstorm golden, byte for byte, from the
    port's fleet on the reference's byte models, bandwidths and names (the
    poisoned rule names the port's ``torch``, the reference's ``xla``)."""
    engine, _ = reference_models
    cfg, run = _fleet_faultstorm(engine)
    cfg.service = dataclasses.replace(cfg.service, hbm_gbps=819.0, nvlink_gbps=90.0)
    fresh = to_reference(run())
    assert _canonical(fresh) == _canonical(_golden("fleet_faultstorm")), json.dumps(fresh, indent=1, sort_keys=True)


def test_port_faultstorm_golden_matches():
    _, run = _fleet_faultstorm(lambda: sim.reference_engine(device="cpu"))
    fresh = run()
    assert _canonical(fresh) == _canonical(_golden("torch_fleet_faultstorm")), json.dumps(fresh, indent=1,
                                                                                           sort_keys=True)


def test_faultstorm_golden_acceptance_claims():
    """What the port's storm must show (the reference's claims): at least
    5 % transients recovered at >= 90 %, the poisoned signature's breakers
    tripped and its requests served demoted, hedging against the
    straggler, nothing lost and nothing served twice."""
    g = _golden("torch_fleet_faultstorm")
    req, r = g["requests"], g["resilience"]
    assert req["conserved"] is True and req["served_twice"] == 0
    assert req["arrived"] == (req["refused"] + req["no_replica"] + req["completed"] + req["demoted"]
                              + sum(req["rejected"].values()))
    assert r["faults"]["transient"] > 0.05 * req["arrived"] * 0.5
    assert r["retries"] > 0 and r["recovery_rate"] >= 0.9
    assert r["breaker"]["trips"] >= 1
    assert any("torch/int8w/32x32x32" in s for s in r["breaker"]["open_signatures"])
    assert r["rungs"].get("streaming/streaming", 0) > 0
    assert r["hedges"] > 0 and r["hedge_cancelled"] + r["hedge_wins"] > 0
    for rep in g["per_replica"]:
        assert rep["admitted"] == rep["completed"] + rep["demoted"] + rep["rejected"] + rep["evacuated"]


def test_faultstorm_is_deterministic():
    _, run = _fleet_faultstorm(lambda: sim.reference_engine(device="cpu"))
    assert _canonical(run()) == _canonical(run())
