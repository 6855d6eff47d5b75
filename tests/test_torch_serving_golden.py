"""Golden traces of the port's load simulator (serving/simulator.py).

1. The reference's goldens, ``tests/golden/serving_{steady,burst,
   overload}.json``, reproduced byte for byte by the port's ``simulate``
   on ``reference_engine(device="cpu")``. The port prices service with the
   Hopper byte models and an H100's bandwidths; to reproduce the
   reference's numbers the test injects the reference's own models, and
   nothing else (the ``reference_models`` fixture):
     - ``repro_torch.core.executors.modeled_hbm_bytes`` and
       ``modeled_collective_bytes`` call ``repro.core.executors``' own,
       the executor's name translated by ``executors.reference_name``;
     - the preset's ``ServiceModel`` bandwidths become the reference's
       819 GB/s and 90 GB/s;
     - the engine's budget becomes ``MemoryBudget.v5e()``.
2. The port's own goldens, ``tests/golden/torch_serving_*.json``, under
   its defaults (``tools/write_serving_goldens.py`` writes them), and the
   reference's two checks on what the scenarios must keep exercising.
3. Decision-level parity: on a modeled trace of a few hundred arrivals,
   serialized and ``_batched``, each request's outcome, mode, executor,
   precision, fail type, batch size and dispatch index equal the
   reference's.
"""

import dataclasses
import json
import os

import pytest

from repro.core import executors as ref_executors
from repro.core import meshnet as ref_meshnet
from repro.serving import scheduler as ref_scheduler
from repro.serving import simulator as ref_sim
from repro_torch.core import executors
from repro_torch.serving import scheduler
from repro_torch.serving import simulator as sim
from repro_torch.telemetry.budget import MemoryBudget

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def _canonical(summary):
    return json.dumps(summary, sort_keys=True)


@pytest.fixture
def reference_models(monkeypatch):
    """The reference's byte models in the port's executors module, for
    the duration of a test. Returns the two other injections: an engine
    with the reference's budget, and a preset with its bandwidths."""

    def ref_cfg(cfg):
        return ref_meshnet.MeshNetConfig(**dataclasses.asdict(cfg))

    def hbm(name, cfg, vol, batch=1, precision="fp32", *, device=None):
        return ref_executors.modeled_hbm_bytes(
            executors.reference_name(name), ref_cfg(cfg), vol, batch=batch, precision=precision
        )

    def collective(name, cfg, vol, batch=1, precision="fp32", *, device=None):
        return ref_executors.modeled_collective_bytes(
            executors.reference_name(name), ref_cfg(cfg), vol, batch=batch, precision=precision
        )

    monkeypatch.setattr(executors, "modeled_hbm_bytes", hbm)
    monkeypatch.setattr(executors, "modeled_collective_bytes", collective)

    def engine():
        eng = sim.reference_engine(device="cpu")
        eng.budget = MemoryBudget.v5e()
        return eng

    def preset(name, **kw):
        cfg = sim.preset(name, **kw)
        cfg.service = dataclasses.replace(cfg.service, hbm_gbps=819.0, nvlink_gbps=90.0)
        return cfg

    return engine, preset


@pytest.mark.parametrize("name", ["steady", "burst", "overload"])
def test_reference_golden_reproduced_byte_for_byte(reference_models, name):
    engine, preset = reference_models
    fresh = sim.simulate(engine(), preset(name, seed=0)).summary()
    assert _canonical(fresh) == _canonical(_load(f"serving_{name}.json")), (
        f"serving scenario {name!r} diverged from the reference's golden; fresh summary:\n"
        f"{json.dumps(fresh, indent=1, sort_keys=True)}"
    )


@pytest.mark.parametrize("name", ["steady", "burst", "overload"])
def test_port_golden_matches(name):
    fresh = sim.simulate(sim.reference_engine(device="cpu"), sim.preset(name, seed=0)).summary()
    assert _canonical(fresh) == _canonical(_load(f"torch_serving_{name}.json")), (
        f"serving scenario {name!r} diverged from the port's golden (tools/write_serving_goldens.py); fresh "
        f"summary:\n{json.dumps(fresh, indent=1, sort_keys=True)}"
    )


def test_port_defaults_are_the_cards():
    assert (sim.ServiceModel().hbm_gbps, sim.ServiceModel().nvlink_gbps) == (3350.0, 450.0)
    assert sim.reference_engine(device="cpu").budget == MemoryBudget.h100()


def test_overload_golden_actually_sheds():
    """The port's overload trace keeps exercising every shed lane."""
    golden = _load("torch_serving_overload.json")
    req = golden["requests"]
    assert req["conserved"] is True
    assert req["refused"] > 0, "no queue-full backpressure in the overload golden"
    assert req["demoted"] > 0, "no shed-to-subvolume demotion in the overload golden"
    assert sum(req["rejected"].values()) > 0, "no typed rejection in the overload golden"
    assert req["arrived"] == req["refused"] + req["admitted"]
    assert req["admitted"] == req["completed"] + req["demoted"] + sum(req["rejected"].values())


def test_steady_golden_is_calm():
    """The port's steady trace stays the latency floor: nothing shed, a
    shallow queue."""
    golden = _load("torch_serving_steady.json")
    req = golden["requests"]
    assert req["refused"] == 0 and req["demoted"] == 0
    assert req["rejected"] == {}
    assert golden["max_queue_depth"] <= 4


def _decisions(monkeypatch, sched_cls, simulate, engine, cfg, name_of):
    """Each request's (id, outcome, mode, executor, precision, fail_type,
    batch size, dispatch index), in id order."""
    dispatched = {}
    orig = sched_cls.run_batch

    def recording(self, batch, now=None):
        index = len(set(dispatched.values()))
        for r in batch.requests:
            dispatched[r.id] = index
        return orig(self, batch, now)

    monkeypatch.setattr(sched_cls, "run_batch", recording)
    rep = simulate(engine, cfg)
    monkeypatch.setattr(sched_cls, "run_batch", orig)
    out = []
    for c in rep.completions:
        r = c.record
        out.append((c.id, c.outcome, r.mode, name_of(r.executor), r.precision, r.fail_type, r.batch_size,
                    dispatched.get(c.id)))
    return rep.arrived, out


@pytest.mark.parametrize("name", ["overload", "overload_batched"])
def test_decisions_equal_the_references(monkeypatch, reference_models, name):
    engine, preset = reference_models
    kw = dict(seed=3, horizon_s=60.0)
    arrived, got = _decisions(monkeypatch, scheduler.RequestScheduler, sim.simulate, engine(), preset(name, **kw),
                              lambda e: e if e is None else executors.reference_name(e))
    ref_arrived, expect = _decisions(monkeypatch, ref_scheduler.RequestScheduler, ref_sim.simulate,
                                     ref_sim.reference_engine(), ref_sim.preset(name, **kw), lambda e: e)
    assert arrived == ref_arrived and 200 <= arrived <= 600
    assert got == expect
    outcomes = {d[1] for d in got}
    # batched launches keep every deadline on this trace; serialized ones do not
    assert outcomes == ({"completed", "demoted"} if name.endswith("_batched") else {"completed", "demoted", "rejected"})
    assert max(d[6] or 0 for d in got) > 1  # some group of several
