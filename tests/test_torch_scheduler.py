"""The port's request scheduler and the engine's queued entry points
(serving/scheduler.py, serving/engine.py): the counterparts of the
reference's tests/test_scheduler.py (admission, modeled execution,
ordering, telemetry stamping, the queued API), its property suite's
pinned grid (tests/test_scheduler_properties.py::TestGridFallback), the
hooks item 13b brought (resilience, fault plans, the cache, content
skew) against the reference's, and queued execution against the
reference's engine on the same bridged weights.

Everything runs on the CPU: the virtual clock with modeled execution
(``execute=False``) except the engine tests, which run the pipeline at
16^3 under executor ``torch`` (the reference's ``xla``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.core.pipeline import PipelineConfig as RefPipelineConfig
from repro.serving import scheduler as ref_scheduler
from repro.serving.engine import SegmentationEngine as RefEngine
from repro_torch import bridge
from repro_torch.core import executors, meshnet
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.engine import SegmentationEngine
from repro_torch.serving.scheduler import PriorityClass, QueueFullError, RequestScheduler, SchedulerConfig
from repro_torch.serving.simulator import ScenarioSpec, ServiceModel, SimConfig, VirtualClock, simulate

from test_torch_resilience import modeled_ref_engine, reference_names, simulate_both  # noqa: F401  (fixture)
from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)

SMALL = dict(dilations=(1, 2, 4), channels=5)


def make_engine(volume_shape=(16, 16, 16), params=None, **cfg_kwargs):
    cfg = MeshNetConfig(**SMALL)
    if params is None:
        params = meshnet.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    cfg_kwargs.setdefault("executor", "torch")
    pc = PipelineConfig(model=cfg, volume_shape=volume_shape, cube=8, overlap=4, min_component_size=4, **cfg_kwargs)
    return SegmentationEngine(params, pc, device="cpu")


def make_sched(engine=None, *, clock=None, execute=False, **cfg_kwargs):
    engine = engine or make_engine()
    cfg_kwargs.setdefault("native_shapes", True)
    return RequestScheduler(
        engine, SchedulerConfig(**cfg_kwargs), clock=clock or VirtualClock(), service_model=ServiceModel(),
        execute=execute,
    )


def vol(shape=(16, 16, 16), seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ------------------------------------------------------------ admission ---


class TestAdmission:
    def test_queue_full_is_typed_and_logged(self):
        sched = make_sched(max_queue_depth=2)
        sched.submit(vol(), arrival_s=0.0)
        sched.submit(vol(), arrival_s=0.0)
        with pytest.raises(QueueFullError) as ei:
            sched.submit(vol(), arrival_s=0.0)
        assert ei.value.limit == 2
        assert sched.stats.refused == 1
        shed = [r for r in sched.engine.log.records if r.fail_type == "queue_full"]
        assert len(shed) == 1 and shed[0].status == "fail"
        assert sched.stats.admitted == 2

    def test_admission_budget_never_exceeded_per_batch(self):
        per = make_sched()._price("streaming", (16, 16, 16), "fp32")
        sched = make_sched(admission_hbm_bytes=2 * per + per // 2, max_batch_requests=8, allow_demotion=False)
        for i in range(5):
            sched.submit(vol(seed=i), mode="streaming", arrival_s=0.0)
        sizes = []
        while True:
            b = sched.next_batch(now=1.0)
            if b is None:
                break
            assert sum(r.bytes_priced for r in b.requests) <= sched.cfg.admission_hbm_bytes
            sizes.append(len(b.requests))
            sched.run_batch(b)
        assert sizes == [2, 2, 1]
        assert sched.stats.conserved()

    def test_oversized_request_demotes_to_subvolume(self):
        sched = make_sched(admission_hbm_bytes=300_000)  # < 32^3 streaming
        sched.submit(vol((32, 32, 32)), mode="streaming", arrival_s=0.0)
        b = sched.next_batch(now=0.0)
        assert len(b.requests) == 1
        req = b.requests[0]
        assert req.demoted and req.key.mode == "subvolume"
        sched.run_batch(b)
        assert sched.stats.demoted == 1 and sched.stats.completed == 0
        rec = sched.completions[0].record
        assert rec.demoted and rec.mode == "subvolume"

    def test_demoted_requests_still_group(self):
        sched = make_sched(admission_hbm_bytes=700_000, max_batch_requests=8)
        for i in range(3):
            sched.submit(vol((32, 32, 32), seed=i), mode="streaming", arrival_s=0.0)
        b = sched.next_batch(now=0.0)
        assert len(b.requests) == 3
        assert all(r.demoted and r.key.mode == "subvolume" for r in b.requests)
        sched.run_batch(b)
        assert sched.stats.demoted == 3
        assert sched.completions[0].record.batch_size == 3
        assert sched.stats.conserved()

    def test_unservable_request_rejected_typed(self):
        sched = make_sched(admission_hbm_bytes=1024)
        sched.submit(vol(), arrival_s=0.0)
        assert sched.next_batch(now=0.0) is None
        assert sched.stats.rejected == {"admission_oom": 1}
        comp = sched.completions[0]
        assert comp.outcome == "rejected" and comp.record.fail_type == "admission_oom"
        assert sched.stats.conserved()

    def test_deadline_expiry_sheds_typed(self):
        clock = VirtualClock()
        sched = make_sched(clock=clock, classes={"rt": PriorityClass("rt", 0, deadline_s=1.0)})
        sched.submit(vol(), priority="rt", arrival_s=0.0)
        clock.advance_to(5.0)
        assert sched.next_batch() is None
        assert sched.stats.rejected == {"deadline_expired": 1}
        assert sched.completions[0].record.priority_class == "rt"

    def test_executor_is_resolved_for_the_engines_device(self, monkeypatch):
        """``auto`` is priced and grouped as the executor the engine's own
        device runs: ``torch`` for a CPU engine even on a host with a
        card."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert executors.resolve("auto") == "cuda_fused"
        sched = make_sched(make_engine(executor="auto"), admission_hbm_bytes=300_000)
        sched.submit(vol(), arrival_s=0.0)
        sched.submit(vol((32, 32, 32)), mode="streaming", arrival_s=0.0)
        b = sched.next_batch(now=0.0)
        assert b.requests[0].key.executor == "torch"
        b = sched.next_batch(now=0.0)
        assert b.requests[0].demoted and b.requests[0].key.executor == "torch"


class TestModeledExecution:
    def test_modeled_record_carries_bytes_and_status(self):
        sched = make_sched()
        sched.submit(vol(), arrival_s=0.0)
        sched.run_batch(sched.next_batch(now=0.0))
        rec = sched.completions[0].record
        assert rec.status == "ok" and rec.executor == "torch"
        assert rec.hbm_bytes_modeled and rec.hbm_bytes_modeled > 0
        assert rec.params_bytes and rec.params_bytes > 0

    def test_modeled_geometry_failure_is_typed(self):
        sched = make_sched()  # the CPU is one device: 3 slabs cannot run
        sched.submit(vol(), devices=3, arrival_s=0.0)
        sched.run_batch(sched.next_batch(now=0.0))
        rec = sched.completions[0].record
        assert rec.status == "fail" and rec.fail_type == "shard_geometry"
        assert sched.stats.conserved()

    def test_modeled_garbage_failure_is_typed_and_solo(self):
        sched = make_sched()
        sched.submit(np.zeros((5,), np.float32), arrival_s=0.0)
        sched.submit(vol(), arrival_s=0.0)
        b = sched.next_batch(now=0.0)
        assert len(b.requests) == 1
        sched.run_batch(b)
        assert sched.completions[0].record.fail_type == "permanent_fault"


class TestOrdering:
    def test_priority_preempts_arrival_order(self):
        sched = make_sched()
        a = sched.submit(vol(seed=1), priority="batch", arrival_s=0.0)
        b = sched.submit(vol(seed=2), priority="interactive", arrival_s=1.0)
        batch = sched.next_batch(now=2.0)
        assert [r.id for r in batch.requests] == [b]
        sched.run_batch(batch)
        assert [r.id for r in sched.next_batch(now=3.0).requests] == [a]

    def test_fifo_within_class_and_signature(self):
        sched = make_sched(max_batch_requests=2)
        ids = [sched.submit(vol(seed=i), arrival_s=float(i)) for i in range(5)]
        served = []
        while True:
            b = sched.next_batch(now=10.0)
            if b is None:
                break
            served.extend(r.id for r in b.requests)
            sched.run_batch(b)
        assert served == ids

    def test_grouping_merges_compatible_requests_only(self):
        sched = make_sched(max_batch_requests=8)
        sched.submit(vol(seed=0), precision="bf16", arrival_s=0.0)
        sched.submit(vol(seed=1), precision="fp32", arrival_s=0.0)
        sched.submit(vol(seed=2), precision="bf16", arrival_s=0.0)
        b = sched.next_batch(now=0.0)
        assert [r.key.precision for r in b.requests] == ["bf16", "bf16"]
        sched.run_batch(b)
        assert sched.completions[0].record.batch_size == 2


class TestTelemetryStamping:
    def test_queue_and_service_stamps(self):
        clock = VirtualClock()
        sched = make_sched(clock=clock)
        sched.submit(vol(), arrival_s=0.0)
        clock.advance_to(2.0)
        finish = sched.run_batch(sched.next_batch())
        rec = sched.completions[0].record
        assert rec.arrival_s == 0.0
        assert rec.queue_wait_s == pytest.approx(2.0 + ServiceModel().batch_overhead_s)
        assert rec.service_s > 0
        assert rec.batch_size == 1 and rec.priority_class == "standard"
        assert finish == pytest.approx(rec.arrival_s + rec.queue_wait_s + rec.service_s)

    def test_wait_plus_service_is_end_to_end_for_every_batch_member(self):
        sched = make_sched(max_batch_requests=4)
        for i in range(4):
            sched.submit(vol(seed=i), arrival_s=0.0)
        sched.run_batch(sched.next_batch(now=1.0))
        for c in sched.completions:
            assert c.finish_s - c.arrival_s == pytest.approx(c.record.queue_wait_s + c.record.service_s)
        waits = [c.record.queue_wait_s for c in sorted(sched.completions, key=lambda c: c.id)]
        assert waits == sorted(waits) and waits[-1] > waits[0]

    def test_slo_attainment_counts_failures_as_misses(self):
        from repro_torch.telemetry import analysis

        engine = make_engine()
        sched = make_sched(engine)
        sched.submit(vol(), arrival_s=0.0)
        sched.submit(np.zeros((5,), np.float32), arrival_s=0.0)
        sched.drain()
        assert analysis.slo_attainment(engine.log.records, {"standard": 1e9})["standard"] == pytest.approx(0.5)

    def test_resolution_cached_per_signature(self):
        engine = make_engine()
        calls = {"pick_mode": 0}
        orig = engine.pick_mode

        def counting(shape, precision=None):
            calls["pick_mode"] += 1
            return orig(shape, precision)

        engine.pick_mode = counting
        sched = make_sched(engine)
        for i in range(6):
            sched.submit(vol(seed=i), arrival_s=0.0)
        for i in range(3):
            sched.submit(vol((32, 32, 32), seed=i), arrival_s=0.0)
        assert calls["pick_mode"] == 2 and sched.stats.resolutions == 2


class TestRouterHooks:
    """What the fleet of item 13c calls: evacuate, cancel, peek_signature,
    next_ready_s, run_batch_until."""

    def test_evacuate_and_cancel_conserve(self):
        sched = make_sched()
        ids = [sched.submit(vol(seed=i), arrival_s=float(i)) for i in range(4)]
        assert sched.cancel(ids[1]).id == ids[1]
        assert sched.cancel(99) is None
        assert [r.id for r in sched.evacuate()] == [ids[0], ids[2], ids[3]]
        assert sched.stats.evacuated == 4 and sched.stats.conserved() and not sched.has_work()

    def test_peek_shares_the_resolution_cache(self):
        sched = make_sched()
        key, bts = sched.peek_signature(vol(), precision="bf16")
        assert key.precision == "bf16" and key.mode == "streaming" and bts > 0
        sched.submit(vol(), precision="bf16", arrival_s=0.0)
        assert sched.stats.resolutions == 1 and sched.next_ready_s(0.0) is None

    def test_run_batch_until_serves_what_fits(self):
        sched = make_sched(max_batch_requests=4)
        for i in range(4):
            sched.submit(vol(seed=i), arrival_s=0.0)
        b = sched.next_batch(now=0.0)
        one = ServiceModel().service_s(sched._modeled_record(b.requests[0]))
        t, tail = sched.run_batch_until(b, until=ServiceModel().batch_overhead_s + 2.5 * one, now=0.0)
        assert [r.id for r in tail] == [r.id for r in b.requests[2:]]
        assert len(sched.completions) == 2 and t == pytest.approx(ServiceModel().batch_overhead_s + 2 * one)
        with pytest.raises(ValueError, match="modeled path"):
            make_sched(execute=True).run_batch_until(b, until=1.0)


# ------------------------------------------ the hooks item 13b brought ---


def ref_sched(**cfg_kwargs):
    """The reference's scheduler over ``make_engine``'s configuration, on
    the modeled path (which reads no weights, so the engine has none)."""
    from repro.core.meshnet import MeshNetConfig as RefMeshNetConfig
    from repro.serving import simulator as ref_sim

    cfg_kwargs.setdefault("native_shapes", True)
    pc = RefPipelineConfig(model=RefMeshNetConfig(**SMALL), volume_shape=(16, 16, 16), cube=8, overlap=4,
                           min_component_size=4, executor="xla")
    return ref_scheduler.RequestScheduler(RefEngine(None, pc), ref_scheduler.SchedulerConfig(**cfg_kwargs),
                                          clock=ref_sim.VirtualClock(), service_model=ref_sim.ServiceModel(),
                                          execute=False)


def _hook(name, res_mod, cache_mod, executor):
    if name == "resilience":
        return res_mod.ResiliencePolicy(retry=res_mod.RetryPolicy(max_attempts=3, seed=0),
                                        breaker=res_mod.BreakerConfig(trip_after=1, cooldown_s=1e9))
    if name == "fault_plan":
        return res_mod.FaultPlan(seed=2, rules=(res_mod.FaultRule(kind="transient", rate=0.4),
                                                res_mod.FaultRule(kind="permanent", rate=0.3, executor_substr=executor)))
    return cache_mod.ArtifactCache()


@pytest.mark.parametrize("hook", ["resilience", "fault_plan", "cache"])
def test_scheduler_takes_what_13b_brings(hook):
    """Each hook constructs in the port and decides as the reference's:
    with a resilience policy (and the fault plan it retries), a fault plan
    alone, and a cache, the same requests (two repeated volumes among
    them) end with the same outcome, attempt, fail type, mode, executor
    and cache_hit, and the same counters."""
    from repro.serving import cache as ref_cache
    from repro.serving import resilience as ref_res
    from repro_torch.serving import cache, resilience

    seen = []
    for sched, res_mod, cache_mod, x in ((make_sched(), resilience, cache, "torch"),
                                         (ref_sched(), ref_res, ref_cache, "xla")):
        kw = {hook: _hook(hook, res_mod, cache_mod, x)}
        if hook == "resilience":
            kw["fault_plan"] = _hook("fault_plan", res_mod, cache_mod, x)
        sched = type(sched)(sched.engine, sched.cfg, clock=sched.clock, service_model=sched.service_model,
                            execute=False, **kw)
        for i, seed in enumerate((0, 1, 0, 2, 1, 3, 4, 5)):
            sched.submit(vol(seed=seed), priority=("interactive", "standard")[i % 2], arrival_s=0.0)
        comps = sched.drain()
        seen.append(([(c.id, c.outcome, c.record.attempt, c.record.fail_type, c.record.mode,
                       executors.REFERENCE_NAMES.get(c.record.executor, c.record.executor), c.record.cache_hit)
                      for c in comps], dataclasses.astuple(sched.stats)))
    assert seen[0] == seen[1]
    assert sched.stats.conserved()


SIM_HOOKS = {
    "resilience": lambda m, c, x: dict(resilience=m.ResiliencePolicy(retry=m.RetryPolicy(max_attempts=2, seed=0))),
    "fault_plan": lambda m, c, x: dict(fault_plan=m.FaultPlan(seed=0, rules=(m.FaultRule(kind="transient", rate=0.2),
                                                                           m.FaultRule(kind="straggler", rate=0.3)))),
    "cache": lambda m, c, x: dict(cache=c.CacheConfig(), content_skew=1.1, content_universe=8),
    "content_skew": lambda m, c, x: dict(content_skew=1.1),
}


@pytest.mark.parametrize("field", sorted(SIM_HOOKS))
def test_simulator_takes_what_13b_brings(reference_models, reference_names, field):  # noqa: F811
    """Each ``SimConfig`` field item 13b brought runs in the port: the
    steady preset's 60 virtual seconds with it set give the reference's
    summary (its byte models and the cache payload's executor names
    injected, the summary's names mapped), with the resilience and cache
    blocks exactly when their layer is configured."""
    rep, got, expect = simulate_both(reference_models, modeled_ref_engine(), "steady", SIM_HOOKS[field])
    assert json.dumps(got, sort_keys=True) == json.dumps(expect, sort_keys=True)
    assert ("resilience" in got) == (field in ("resilience", "fault_plan"))
    assert ("cache" in got) == (field == "cache")


# ------------------------------------- the property suite's pinned grid ---

MIX_ENTRIES = [
    ScenarioSpec(shape=(16, 16, 16), priority="interactive"),
    ScenarioSpec(shape=(16, 16, 16), precision="bf16"),
    ScenarioSpec(shape=(32, 32, 32), precision="int8w"),
    ScenarioSpec(shape=(32, 32, 32)),
    ScenarioSpec(shape=(32, 32, 32), mode="subvolume", priority="batch"),
    ScenarioSpec(garbage=True),
]


def _sim_cfg(seed, rate, depth, cap_mib, mix):
    return SimConfig(
        name="prop",
        seed=seed,
        horizon_s=60.0,
        process="poisson",
        process_kwargs={"rate_hz": rate},
        mix=tuple(mix),
        scheduler=SchedulerConfig(
            max_queue_depth=depth,
            admission_hbm_bytes=cap_mib * 1024 * 1024,
            max_batch_requests=4,
            native_shapes=True,
            classes={
                "interactive": PriorityClass("interactive", 0, deadline_s=5.0),
                "standard": PriorityClass("standard", 1, deadline_s=20.0),
                "batch": PriorityClass("batch", 2, deadline_s=None),
            },
        ),
        service=ServiceModel(base_s=0.05, batch_overhead_s=0.02),
    )


@pytest.mark.parametrize("seed,rate,depth,cap_mib", [(0, 0.5, 2, 1), (1, 6.0, 8, 4), (2, 12.0, 40, 64), (3, 9.0, 3, 2)])
def test_conservation_and_no_starvation(seed, rate, depth, cap_mib):
    rep = simulate(make_engine(), _sim_cfg(seed, rate, depth, cap_mib, MIX_ENTRIES))
    st = rep.scheduler.stats
    assert st.conserved() and not rep.scheduler.queue
    assert rep.arrived == rep.refused + st.admitted
    ids = [c.id for c in rep.completions]
    assert len(ids) == len(set(ids)) == st.admitted


@pytest.mark.parametrize("seed,rate,cap_mib", [(0, 2.0, 1), (1, 12.0, 8)])
def test_admission_never_exceeds_budget(monkeypatch, seed, rate, cap_mib):
    cfg = _sim_cfg(seed, rate, 40, cap_mib, [ScenarioSpec(), ScenarioSpec(shape=(32, 32, 32))])
    seen = []
    orig = RequestScheduler.run_batch

    def checking(self, batch, now=None):
        seen.append(sum(r.bytes_priced for r in batch.requests))
        return orig(self, batch, now)

    monkeypatch.setattr(RequestScheduler, "run_batch", checking)
    simulate(make_engine(), cfg)
    assert seen and all(total <= cfg.scheduler.admission_hbm_bytes for total in seen)


@pytest.mark.parametrize("seed,rate", [(0, 1.0), (1, 10.0)])
def test_fifo_within_class_per_signature(seed, rate):
    rep = simulate(make_engine(), _sim_cfg(seed, rate, 64, 64, [ScenarioSpec(), ScenarioSpec(precision="bf16")]))
    starts: dict = {}
    for c in rep.completions:
        if c.outcome == "rejected":
            continue
        r = c.record
        starts.setdefault((r.priority_class, r.mode, r.executor, r.precision), []).append((c.arrival_s, c.finish_s, c.id))
    for group in starts.values():
        assert [g[2] for g in sorted(group)] == [g[2] for g in sorted(group, key=lambda t: (t[1], t[2]))]


@pytest.mark.parametrize("seed", [0, 7])
def test_virtual_clock_determinism(seed):
    cfg = _sim_cfg(seed, 6.0, 16, 2, [ScenarioSpec(), ScenarioSpec(shape=(32, 32, 32)), ScenarioSpec(garbage=True)])
    engines = [make_engine(), make_engine()]
    reps = [simulate(e, cfg) for e in engines]
    assert reps[0].to_json() == reps[1].to_json()
    assert [r.to_json() for r in engines[0].log.records] == [r.to_json() for r in engines[1].log.records]


# ---------------------------------------------------- the queued engine ---


class TestEngineQueuedAPI:
    """submit_async/drain and submit_many on the real pipeline (16^3,
    executor torch on the CPU)."""

    def test_submit_async_drain_real_execution(self):
        engine = make_engine()
        ids = [engine.submit_async(vol(seed=i)) for i in range(3)]
        comps = engine.drain()
        assert [c.id for c in comps] == ids
        for c in comps:
            assert c.outcome == "completed" and c.result.record.status == "ok"
            assert c.result.segmentation.shape == (16, 16, 16)
            assert c.record.batch_size >= 1 and c.record.service_s is not None

    def test_drain_returns_only_new_completions(self):
        engine = make_engine()
        first = engine.submit_async(vol(seed=0))
        assert [c.id for c in engine.drain()] == [first]
        second = engine.submit_async(vol(seed=1))
        assert [c.id for c in engine.drain()] == [second]
        assert engine.drain() == []

    def test_submit_many_never_sheds_on_wall_clock(self, monkeypatch):
        class JumpyClock:  # every reading is 500 s later than the last
            def __init__(self):
                self.t = 0.0

            def now(self):
                self.t += 500.0
                return self.t

        monkeypatch.setattr(sched_mod, "_MonotonicClock", JumpyClock)
        results = make_engine().submit_many([vol(seed=i) for i in range(3)], precisions=[None, "bf16", None])
        assert [r.record.status for r in results] == ["ok"] * 3

    def test_scheduler_config_after_creation_raises(self):
        engine = make_engine()
        engine.submit_async(vol())
        with pytest.raises(ValueError, match="first use"):
            engine.scheduler(SchedulerConfig(max_queue_depth=4))
        engine.drain()

    def test_submit_many_quantize_once_per_policy(self, monkeypatch):
        from repro_torch.kernels import quantize

        engine = make_engine()
        calls = {"n": 0}
        orig = quantize.prepare_params

        def counting(params, cfg, precision):
            calls["n"] += params is engine.params  # not the executors' calls on a prepared tree
            return orig(params, cfg, precision)

        monkeypatch.setattr(quantize, "prepare_params", counting)
        engine.submit_many([vol(seed=i) for i in range(6)], precisions=[None, "bf16", "int8w", "bf16", "int8w", None])
        assert len(engine._prepared) == 3 and calls["n"] == 3
        before = {k: id(v) for k, v in engine._prepared.items()}
        engine.submit_many([vol(seed=9)], precisions=["int8w"])
        assert {k: id(v) for k, v in engine._prepared.items()} == before

    def test_submit_many_grouping_dedupes_resolution(self):
        engine = make_engine()
        calls = {"n": 0}
        orig = engine.pick_mode

        def counting(shape, precision=None):
            calls["n"] += 1
            return orig(shape, precision)

        engine.pick_mode = counting
        results = engine.submit_many([vol(seed=i) for i in range(5)])
        assert calls["n"] == 1
        assert [r.record.extra["request_index"] for r in results] == list(range(5))
        assert all(r.record.status == "ok" for r in results)
        assert results[0].record.batch_size == 5

    def test_submit_many_types_a_garbage_volume(self):
        results = make_engine().submit_many([vol(seed=0), np.zeros((3,), np.float32), vol(seed=1)])
        assert [r.record.status for r in results] == ["ok", "fail", "ok"]
        assert results[1].segmentation is None and results[1].record.fail_type == "permanent_fault"
        assert [r.record.extra["request_index"] for r in results] == [0, 1, 2]

    def test_native_shapes_serve_at_the_priced_geometry(self):
        engine = make_engine()
        engine.scheduler(SchedulerConfig(native_shapes=True))
        rid = engine.submit_async(vol((12, 16, 20)))
        (comp,) = engine.drain()
        assert comp.id == rid and comp.record.status == "ok"
        assert tuple(comp.result.segmentation.shape) == (12, 16, 20)
        assert engine.scheduler().completions[0].record.mode == "streaming"


# ---------------------------------- queued execution against the reference ---


def _np_params(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    layers, cin, c = [], 1, SMALL["channels"]
    for _ in SMALL["dilations"]:
        layers.append({
            "w": (rng.standard_normal((3, 3, 3, cin, c)) * np.sqrt(2.0 / (27 * cin))).astype(f32),
            "b": (0.1 * rng.standard_normal(c)).astype(f32),
            "bn_scale": (1.0 + 0.2 * rng.standard_normal(c)).astype(f32),
            "bn_bias": (0.1 * rng.standard_normal(c)).astype(f32),
            "bn_mean": (0.3 * rng.standard_normal(c)).astype(f32),
            "bn_var": (0.5 + rng.random(c)).astype(f32),
        })
        cin = c
    n = MeshNetConfig(**SMALL).num_classes
    head = {"w": (rng.standard_normal((1, 1, 1, c, n)) * np.sqrt(2.0 / c)).astype(f32),
            "b": (0.1 * rng.standard_normal(n)).astype(f32)}
    return {"layers": layers, "head": head}


def _brain(shape, seed):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((zz / 0.6) ** 2 + (yy / 0.8) ** 2 + (xx / 0.7) ** 2)
    return (np.where(r < 1.0, 120.0 - 60.0 * r, 5.0) + 8.0 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def both_engines():
    """A port engine and a reference engine on the same weights, 16^3,
    executor torch and xla."""
    tree = _np_params(3)
    kw = dict(volume_shape=(16, 16, 16), cube=8, overlap=4, min_component_size=4)

    def make():
        ref = RefEngine(jax.tree.map(jnp.asarray, tree),
                        RefPipelineConfig(model=ref_meshnet.MeshNetConfig(**SMALL), executor="xla", **kw))
        return ref, make_engine(params=bridge.params_from_numpy(tree, "cpu"))

    return make


def _same(got, expect):
    assert got.record.status == expect.record.status == "ok"
    assert (got.record.mode, got.record.precision) == (expect.record.mode, expect.record.precision)
    assert executors.reference_name(got.record.executor) == expect.record.executor
    assert (got.record.batch_size, got.record.priority_class) == (expect.record.batch_size, expect.record.priority_class)
    np.testing.assert_array_equal(got.segmentation.numpy(), np.asarray(expect.segmentation))


def test_drain_matches_the_reference(both_engines):
    ref, port = both_engines()
    shapes = [(16, 16, 16), (14, 16, 12), (16, 16, 16), (16, 16, 16)]
    prios = ["batch", "interactive", "standard", "interactive"]
    for i, (shape, prio) in enumerate(zip(shapes, prios)):
        v = _brain(shape, 40 + i)
        assert port.submit_async(v, priority=prio) == ref.submit_async(jnp.asarray(v), priority=prio)
    got, expect = port.drain(), ref.drain()
    assert [(c.id, c.outcome) for c in got] == [(c.id, c.outcome) for c in expect]
    for g, e in zip(got, expect):
        _same(g.result, e.result)
    assert port.scheduler().stats.batches == ref.scheduler().stats.batches == 3


def test_submit_many_matches_the_reference(both_engines):
    ref, port = both_engines()
    vols = [_brain((16, 16, 16), 50 + i) for i in range(4)]
    modes = [None, "subvolume", None, "full"]
    got = port.submit_many(vols, modes=modes, executors=[None, None, "cuda_fused", None])
    expect = ref.submit_many([jnp.asarray(v) for v in vols], modes=modes, executors=[None, None, "pallas_fused", None])
    for g, e in zip(got, expect):
        _same(g, e)
        assert g.record.extra["request_index"] == e.record.extra["request_index"]
    assert port._scheduler is None  # submit_many keeps a scheduler of its own
