"""The port's artifact cache (serving/cache.py) and its threading through
the scheduler, the simulator and the pipeline's conform memo, against the
reference's, after tests/test_cache.py:

  * keys: ``content_hash`` of one volume as a numpy array, as a CPU
    tensor (fp32 and bf16) and as the reference hashes it;
    ``artifact_key``, ``model_fingerprint`` (the port's ``MeshNetConfig``
    has the reference's repr) and ``artifact_bytes_modeled``;
  * the store: the same op sequences on both caches — integrity
    quarantine, negative TTL, LRU that never evicts a pinned entry,
    fail-open with its breaker — give the same answers and stats;
  * the scheduler on the modeled path: single flight, hits, cancel and
    evacuation teardown, demoted leaders, retry exhaustion, each against
    the reference's scheduler; the simulator's cache block with Zipf
    content and a corruption storm equal to the reference's after the
    executor-name map;
  * tensors: no completion shares its segmentation with another or with
    the cache entry, and a memoised conformed volume comes out of a
    served request unchanged.

Everything runs on the CPU at 16^3 or smaller."""

import dataclasses
import json

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.meshnet import MeshNetConfig as RefMeshNetConfig
from repro.serving import cache as ref_cache
from repro.serving import resilience as ref_res
from repro.serving import simulator as ref_sim
from repro.telemetry import record as ref_record
from repro_torch.core import conform, pipeline
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.serving import cache as cache_mod
from repro_torch.serving import resilience as res
from repro_torch.serving import scheduler
from repro_torch.serving import simulator as sim
from repro_torch.serving.cache import ArtifactCache, ConformMemo
from repro_torch.serving.errors import PERMANENT_FAULT, TRANSIENT_FAULT, CacheCorruptionError
from repro_torch.telemetry import record
from repro_torch.telemetry.analysis import cache_summary

from test_torch_resilience import modeled_ref_engine, reference_names, simulate_both  # noqa: F401  (fixture)
from test_torch_scheduler import SMALL, make_engine, make_sched, ref_sched, vol
from test_torch_serving_golden import reference_models  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with a test worker on every core, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ok_record(rec_mod, request_id=0, **kw):
    defaults = dict(model="m", mode="full", status="ok", times=rec_mod.StageTimes(), executor="xla",
                    precision="fp32", params_bytes=1000, request_id=request_id)
    defaults.update(kw)
    return rec_mod.TelemetryRecord(**defaults)


#: (cache module, resilience module, record module) of each package
PACKAGES = {"port": (cache_mod, res, record), "reference": (ref_cache, ref_res, ref_record)}


def store_one(pkg, cache, key="k0", now=0.0, shape=(8, 8, 8), **rec_kw):
    cm, _, rm = pkg
    cache.begin(key, replica=0, now=now, est_bytes=cm.artifact_bytes_modeled(shape))
    return cache.complete(key, now=now, record=ok_record(rm, **rec_kw), shape=shape)


# --------------------------------------------------------- key derivation ---


def test_content_hash_equals_the_references():
    a = vol(seed=1)
    h = cache_mod.content_hash(a)
    assert h == ref_cache.content_hash(a) == cache_mod.content_hash(torch.from_numpy(a.copy()))
    assert h == cache_mod.content_hash(torch.from_numpy(np.asfortranarray(a)))  # C-order bytes either way
    assert h != cache_mod.content_hash(vol(seed=2))
    assert h != cache_mod.content_hash(a.reshape(16, 8, 32)) == ref_cache.content_hash(a.reshape(16, 8, 32))
    b = torch.from_numpy(a).to(torch.bfloat16)
    as_ml = b.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    assert cache_mod.content_hash(b) == ref_cache.content_hash(as_ml) != h
    i = (a * 100).astype(np.int16)
    assert cache_mod.content_hash(torch.from_numpy(i)) == ref_cache.content_hash(i)


def test_stub_identity_and_uncacheable_none():
    for cm in (cache_mod, ref_cache):
        stub = sim._ShapeStub
        assert cm.content_hash(stub((16, 16, 16), 3)) == cm.content_hash(stub((16, 16, 16), 3))
        assert cm.content_hash(stub((16, 16, 16), 3)) != cm.content_hash(stub((16, 16, 16), 4))
        assert cm.content_hash(stub((16, 16, 16))) is None and cm.content_hash(object()) is None
    assert cache_mod.content_hash(sim._ShapeStub((8, 8, 8), 5)) == ref_cache.content_hash(ref_sim._ShapeStub((8, 8, 8), 5))


class _Repr:
    """An object whose repr is the given text."""

    def __init__(self, text):
        self.text = text

    def __repr__(self):
        return self.text


@pytest.mark.parametrize("cfg", [{}, SMALL, dict(channels=21, dilations=(1, 2, 4, 8, 16, 8, 4, 2, 1), num_classes=3)])
def test_model_fingerprint_and_keys_equal_the_references(cfg):
    """``model_fingerprint`` is the reference's function of the config's
    repr, and the port's repr is the reference's but for its last field:
    the reference's ``MeshNetConfig`` carries a jax ``dtype`` the port's
    has not (ROADMAP.md Queue 3), so one model's fingerprint differs
    between the packages. No decision reads the key's value, only its
    equality with another key of the same package."""
    port_repr = repr(MeshNetConfig(**cfg))
    assert repr(RefMeshNetConfig(**cfg)) == port_repr[:-1] + ", dtype=<class 'jax.numpy.float32'>)"
    fp = cache_mod.model_fingerprint(MeshNetConfig(**cfg))
    assert fp == ref_cache.model_fingerprint(_Repr(port_repr))
    c = cache_mod.content_hash(vol())
    keys = [cache_mod.artifact_key(c, fp, p, m) for p in ("fp32", "bf16", "int8w") for m in ("full", "subvolume")]
    assert keys == [ref_cache.artifact_key(c, fp, p, m) for p in ("fp32", "bf16", "int8w") for m in ("full", "subvolume")]
    assert len(set(keys)) == len(keys)
    for shape in ((8, 8, 8), (16, 16, 16), (256, 256, 256), (10, 12, 14, 1)):
        assert cache_mod.artifact_bytes_modeled(shape) == ref_cache.artifact_bytes_modeled(shape)


# ---------------------------------------------------------------- the store ---


def _integrity(pkg):
    cm, rm_res, _ = pkg
    out = []
    cache = cm.ArtifactCache()
    out.append(store_one(pkg, cache))
    look = cache.lookup("k0", now=1.0)
    out += [look.status, cache.serve_payload(look.entry)]
    cm.ArtifactCache._corrupt(cache.entries["k0"])
    out.append(cache.lookup("k0", now=2.0).status)  # quarantined at lookup
    store_one(pkg, cache, key="k1")
    cm.ArtifactCache._corrupt(cache.entries["k1"])
    try:
        cache.serve_payload(cache.entries["k1"])  # the serve-time guard
    except Exception as e:
        out.append(type(e).__name__)
    out.append(cache.lookup("k1", now=3.0).status)
    plan = rm_res.FaultPlan(seed=0, rules=(rm_res.FaultRule(kind="corrupt_entry", rate=1.0, t1=0.5),))
    poisoned = cm.ArtifactCache(fault_plan=plan)
    store_one(pkg, poisoned)
    out += [poisoned.lookup("k0", now=1.0).status, poisoned.summary()]
    return out, cache.summary()


def _negative(pkg):
    cm, _, rm = pkg
    cache = cm.ArtifactCache(cm.CacheConfig(negative_ttl_s=10.0))
    cache.begin("k0", replica=0, now=0.0, est_bytes=512)
    cache.complete("k0", now=0.0, record=ok_record(rm, status="fail", fail_type=PERMANENT_FAULT))
    out = [cache.lookup("k0", now=5.0).status, cache.lookup("k0", now=10.0 + 1e-9).status]
    for ft in (TRANSIENT_FAULT, "service_timeout"):
        cache.begin("k_" + ft, replica=0, now=0.0, est_bytes=512)
        cache.complete("k_" + ft, now=0.0, record=ok_record(rm, status="fail", fail_type=ft))
    return out, cache.summary()


def _eviction(pkg):
    cm = pkg[0]
    one = cm.artifact_bytes_modeled((8, 8, 8)) + 200
    cache = cm.ArtifactCache(cm.CacheConfig(capacity_bytes=3 * one))
    for i, t in enumerate([0.0, 1.0, 2.0]):
        store_one(pkg, cache, key=f"k{i}", now=t)
    cache.lookup("k0", now=3.0)
    store_one(pkg, cache, key="k3", now=4.0)
    out = [sorted(cache.entries)]
    pinned = cm.ArtifactCache(cm.CacheConfig(capacity_bytes=2 * cm.artifact_bytes_modeled((8, 8, 8))))
    pinned.begin("lead", replica=0, now=0.0, est_bytes=cm.artifact_bytes_modeled((8, 8, 8)))
    store_one(pkg, pinned, key="big", now=1.0, shape=(12, 12, 12))
    out += [sorted(pinned.entries), pinned.inflight_owner("lead"), pinned.summary()]
    tiny = cm.ArtifactCache(cm.CacheConfig(capacity_bytes=100))
    store_one(pkg, tiny, key="huge", shape=(64, 64, 64))
    out.append(tiny.summary())
    c = cm.ArtifactCache()
    c.begin("k0", replica=0, now=0.0, est_bytes=4096)
    c.abandon("k0")
    c.abandon("k0")
    store_one(pkg, c, key="k1", now=0.0)
    store_one(pkg, c, key="k1", now=1.0)  # last writer wins, the displaced bytes credited
    c.begin("k", replica=0, now=0.0, est_bytes=512)
    c.abandon("k")
    c.begin("k", replica=1, now=1.0, est_bytes=512)
    c.complete("k", now=2.0, record=ok_record(pkg[2]), shape=(8, 8, 8), replica=0)  # a stale leader
    out += [c.inflight_owner("k"), c.summary()]
    return out, cache.summary()


def _fail_open(pkg):
    cm, rm_res, _ = pkg

    def outage(t1=1e9, cooldown_s=30.0):
        plan = rm_res.FaultPlan(seed=0, rules=(rm_res.FaultRule(kind="cache_unavailable", rate=1.0, t1=t1),))
        return cm.ArtifactCache(cm.CacheConfig(breaker_trip_after=3, breaker_cooldown_s=cooldown_s), fault_plan=plan)

    cache = outage()
    out = [cache.lookup("k", now=float(i), request_id=i).status for i in range(4)]
    out.append((cache.breaker.open, cache.breaker.trips))
    recl = outage(t1=10.0, cooldown_s=5.0)
    for i in range(3):
        recl.lookup("k", now=float(i), request_id=i)
    out += [recl.lookup("k", now=8.0, request_id=10).status, recl.lookup("k", now=14.0, request_id=11).status,
            recl.breaker.open]
    slow = cm.ArtifactCache(fault_plan=rm_res.FaultPlan(seed=0, rules=(
        rm_res.FaultRule(kind="slow_cache", rate=1.0, slow_factor=8.0),)))
    store_one(pkg, slow)
    look = slow.lookup("k0", now=1.0)
    out += [look.status, look.slow_factor, slow.summary()]
    down = outage()
    out += [store_one(pkg, down), down.summary()]
    return out, cache.summary()


STORE_DRIVES = {"integrity": _integrity, "negative": _negative, "eviction": _eviction, "fail_open": _fail_open}


@pytest.mark.parametrize("drive", sorted(STORE_DRIVES))
def test_store_answers_and_stats_equal_the_references(drive):
    got = STORE_DRIVES[drive](PACKAGES["port"])
    expect = STORE_DRIVES[drive](PACKAGES["reference"])
    assert got == expect


# ---------------------------------------------- the scheduler, modeled ---


def _drain_all(sched, now=10.0):
    while True:
        b = sched.next_batch(now=now)
        if b is None:
            return
        now = sched.run_batch(b, now=now)


def _flight(sched, cm):
    """The reference's single-flight scenarios on one scheduler: three
    identical requests, a later hit, a cancelled leader, an evacuation."""
    sched.cache = cm.ArtifactCache()
    v = vol(seed=7)
    ids = [sched.submit(v.copy(), arrival_s=0.0) for _ in range(3)]
    queued = len(sched.queue)
    _drain_all(sched)
    hit = sched.submit(v.copy(), arrival_s=20.0)
    w = vol(seed=3)
    lead = sched.submit(w.copy(), arrival_s=21.0)
    sched.submit(w.copy(), arrival_s=21.0)
    cancelled = sched.cancel(lead) is not None
    requeued = (len(sched.queue), len(sched._followers), sched.cache.inflight_owner(sched.queue[0].cache_key))
    _drain_all(sched, now=30.0)
    u = vol(seed=4)
    sched.submit(u.copy(), arrival_s=40.0)
    sched.submit(u.copy(), arrival_s=40.0)
    out = sched.evacuate(now=40.0)
    sums = {r.extra["artifact_checksum"] for r in sched.engine.log.records if "artifact_checksum" in r.extra}
    comps = sorted((c.id, c.outcome, c.record.cache_hit, c.record.status) for c in sched.completions)
    return (ids, queued, hit, cancelled, requeued, [r.id for r in out], len(sums), comps, sched.cache.summary(),
            dataclasses.astuple(sched.stats), sched.stats.conserved())


def _demoted_leader(sched, cm):
    full = sched._price("full", (32, 32, 32), "fp32")
    sub = sched._price("subvolume", (32, 32, 32), "fp32")
    sched.cfg.admission_hbm_bytes = (sub + full) // 2
    sched.cache = cm.ArtifactCache()
    v = vol(shape=(32, 32, 32), seed=11)
    sched.submit(v.copy(), mode="full", arrival_s=0.0)
    sched.submit(v.copy(), mode="full", arrival_s=0.0)
    ckey = sched.queue[0].cache_key
    _drain_all(sched)
    return (ckey in sched.cache.entries, sched.cache.summary(), sched.stats.coalesced, sched.stats.demoted,
            sched.cache.lookup(ckey, now=100.0).status, sched.stats.conserved())


def _retry_exhaustion(sched, cm):
    mod = res if cm is cache_mod else ref_res
    sched.resilience = mod.ResiliencePolicy(retry=mod.RetryPolicy(max_attempts=2, seed=0), breaker=None)
    sched.fault_plan = mod.FaultPlan(seed=0, rules=(mod.FaultRule(kind="transient", rate=1.0),))
    sched.cache = cm.ArtifactCache()
    v = vol(seed=5)
    sched.submit(v.copy(), arrival_s=0.0)
    fol = sched.submit(v.copy(), arrival_s=0.0)
    attached = bool(sched._followers)
    comps = {c.id: c for c in sched.drain()}
    f = comps[fol]
    return (attached, sched.stats.coalesced, f.outcome, f.record.cache_hit, f.record.fail_type, f.record.attempt,
            sched.cache.summary(), sched.stats.conserved())


def _rollup(sched, cm):
    sched.cache = cm.ArtifactCache()
    v = vol(seed=7)
    for _ in range(3):
        sched.submit(v.copy(), arrival_s=0.0)
    _drain_all(sched)
    sched.submit(v.copy(), arrival_s=20.0)
    s = cache_summary(sched.engine.log.records, store_stats=sched.cache.summary())
    return s.requests, s.coalesced, s.admission_hits, s.cache_served, s.computed, s.store_stats


SCHED_DRIVES = {"single_flight": _flight, "demoted_leader": _demoted_leader, "retry_exhaustion": _retry_exhaustion,
                "rollup": _rollup}


@pytest.mark.parametrize("drive", sorted(SCHED_DRIVES))
def test_scheduler_cache_paths_equal_the_references(reference_names, drive):  # noqa: F811
    got = SCHED_DRIVES[drive](make_sched(max_queue_depth=64), cache_mod)
    expect = SCHED_DRIVES[drive](ref_sched(max_queue_depth=64), ref_cache)
    assert got == expect
    assert got[-1] is True or drive == "rollup"


def test_simulator_cache_block_equals_the_references(reference_models, reference_names):  # noqa: F811
    """Zipf content over 16 volumes, a small store (evictions) and a
    corruption storm: the whole summary, cache block included, equals the
    reference's after the executor-name map."""
    rep, got, expect = simulate_both(reference_models, modeled_ref_engine(), "steady", lambda m, c, x: dict(
        cache=c.CacheConfig(capacity_bytes=20_000), content_skew=1.1, content_universe=16,
        fault_plan=m.FaultPlan(seed=0, rules=(m.FaultRule(kind="corrupt_entry", rate=0.1),))), horizon_s=120.0)
    assert json.dumps(got, sort_keys=True) == json.dumps(expect, sort_keys=True)
    block = got["cache"]
    assert block["hits"] > 0 and block["quarantined"] > 0 and block["evictions"] > 0
    assert block["quarantined_served"] == 0


# ------------------------------------------------- executed: tensors ---


def test_no_completion_shares_its_segmentation():
    """Three identical requests and one other, drained through a cache at
    16^3 under executor torch, then the same volume again: one execution a
    content, two coalesced, one hit; every segmentation equals submit's,
    and no two completions, nor a completion and the cache entry, share
    storage — writing into one changes no other."""
    engine = make_engine()
    sched = engine.scheduler(scheduler.SchedulerConfig(native_shapes=True), cache=ArtifactCache())
    v, w = vol(seed=7), vol(seed=8)
    for x in (v, v.copy(), v.copy(), w):
        engine.submit_async(x)
    comps = engine.drain()
    hit = engine.submit_async(v.copy())
    comps += engine.drain()
    assert sorted(c.outcome for c in comps) == ["coalesced", "coalesced", "completed", "completed", "completed"]
    assert sched.stats.cache_hits == 1 and sched.stats.coalesced == 2 and sched.stats.conserved()
    expect = {id(v): engine.submit(v).segmentation, id(w): engine.submit(w).segmentation}
    entries = [e for e in sched.cache.entries.values() if e.result is not None]
    assert len(entries) == 2
    segs = [c.result.segmentation for c in comps] + [e.result.segmentation for e in entries]
    assert len({s.data_ptr() for s in segs}) == len(segs)
    for c in comps:
        assert c.result.record is c.record
        assert torch.equal(c.result.segmentation, expect[id(w)] if c.id == 3 else expect[id(v)])
    hit_seg = next(c for c in comps if c.id == hit).result.segmentation
    before = [s.clone() for s in segs]
    hit_seg.fill_(7)
    for s, b in zip(segs, before):
        assert s is hit_seg or torch.equal(s, b)


def test_degenerate_volume_is_permanent_through_serving():
    sched = make_sched(execute=True)
    sched.cache = ArtifactCache()
    sched.submit(np.zeros((16, 16, 16), np.float32), arrival_s=0.0)
    sched.run_batch(sched.next_batch(now=0.0), now=0.0)
    rec = next(r for r in sched.engine.log.records if r.request_id is not None)
    assert (rec.status, rec.fail_type) == ("fail", "degenerate_volume") and sched.stats.conserved()


def test_serve_payload_breach_is_typed():
    cache = ArtifactCache()
    store_one(PACKAGES["port"], cache)
    ArtifactCache._corrupt(cache.entries["k0"])
    with pytest.raises(CacheCorruptionError):
        cache.serve_payload(cache.entries["k0"])
    assert cache.stats.quarantined_served == 1 and "k0" not in cache.entries


# -------------------------------------------------------------- conform memo ---


def test_conform_memo_fifo_and_keying_equal_the_references():
    trace = []
    for memo in (ConformMemo(max_entries=2), ref_cache.ConformMemo(max_entries=2)):
        vols = [vol(seed=i) for i in range(3)]
        for i, v in enumerate(vols):
            memo.put(v, (16, 16, 16), i)
        out = [memo.get(vols[0], (16, 16, 16)), memo.get(vols[2], (16, 16, 16)), memo.get(vols[2], (8, 8, 8))]

        class NoIdentity:
            shape = (16, 16, 16)

        memo.put(NoIdentity(), (16, 16, 16), "x")
        out += [memo.get(NoIdentity(), (16, 16, 16)), memo.hits, memo.misses, len(memo.entries)]
        trace.append(out)
    assert trace[0] == trace[1] == [None, 2, None, None, 1, 3, 2]
    # the port's memo takes the volume as a tensor too: its numpy identity
    memo = ConformMemo()
    memo.put(vol(seed=1), (16, 16, 16), "conformed")
    assert memo.get(torch.from_numpy(vol(seed=1)), (16, 16, 16)) == "conformed"


def test_conform_memo_hashes_a_volume_once_a_request(monkeypatch):
    """A miss and its put hash the volume once, as a hit does; a put of
    another volume, or of the same volume at another shape, hashes its
    own. The entries' keys are the reference's."""
    calls = []
    content_hash = cache_mod.content_hash
    monkeypatch.setattr(cache_mod, "content_hash", lambda v: calls.append(v) or content_hash(v))
    memo, ref = ConformMemo(), ref_cache.ConformMemo()
    a, b = vol(seed=1), vol(seed=2)
    assert memo.get(a, (16, 16, 16)) is None
    memo.put(a, (16, 16, 16), "A")
    assert len(calls) == 1
    assert memo.get(a, (16, 16, 16)) == "A" and len(calls) == 2
    assert memo.get(a, (8, 8, 8)) is None
    memo.put(b, (8, 8, 8), "B")
    assert len(calls) == 4
    ref.put(a, (16, 16, 16), "A")
    ref.put(b, (8, 8, 8), "B")
    assert list(memo.entries) == list(ref.entries) and (memo.hits, memo.misses) == (1, 2)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_memoised_conform_is_unchanged_by_serving(precision):
    """Two runs of one volume through a pipeline with a ConformMemo: one
    miss, one hit, equal segmentations; the memo's conformed volume is
    bit-equal to a fresh conform after both (the policy cast happens
    after the memo)."""
    engine = make_engine(volume_shape=(12, 12, 12), conform_memo=ConformMemo())
    v = vol((14, 13, 12), seed=9)
    first = engine.submit(v, precision=precision)
    second = engine.submit(v, precision=precision)
    memo = engine.cfg.conform_memo
    assert (memo.hits, memo.misses) == (1, 1)
    assert torch.equal(first.segmentation, second.segmentation)
    (held,) = memo.entries.values()
    assert torch.equal(held, conform.conform(torch.from_numpy(v), (12, 12, 12)))
    plain = make_engine(volume_shape=(12, 12, 12)).submit(v, precision=precision)
    assert torch.equal(plain.segmentation, first.segmentation)
    assert pipeline.PipelineConfig().conform_memo is None
