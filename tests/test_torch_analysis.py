"""The port's telemetry analysis (``repro_torch.telemetry.analysis``)
against the reference's (``repro.telemetry.analysis``): every function on
the same records, built field for field in both packages' TelemetryRecord
from one numpy seed, gives equal results (each summary's ``row()`` string
equal, the estimators' floats equal)."""

import numpy as np
import pytest

from repro.telemetry import analysis as ref_analysis
from repro.telemetry import record as ref_record
from repro_torch.telemetry import analysis, record

FAILS = ("queue_full", "deadline_expired", "admission_oom", "transient_fault", "permanent_fault",
         "service_timeout", "vmem_oom")


def _fields(seed: int, n: int = 400) -> list[dict]:
    """n records' fields: a serving log with classes, replicas, retries of
    one request id, cache hits (some coalesced, some negative), executors
    and precisions, made with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fail = FAILS[rng.integers(len(FAILS))] if rng.random() < 0.3 else None
        hit = bool(rng.random() < 0.2)
        out.append(dict(
            model="gwm_light",
            mode=("full", "subvolume", "streaming")[rng.integers(3)],
            status="fail" if fail else "ok",
            fail_type=fail,
            executor=(None, "torch", "cuda_fused", "cuda_megakernel")[rng.integers(4)],
            precision=(None, "fp32", "bf16", "int8w")[rng.integers(4)],
            hbm_bytes_modeled=None if rng.random() < 0.2 else int(rng.integers(1, 10**9)),
            collective_bytes_modeled=int(rng.integers(0, 10**6)) if rng.random() < 0.5 else None,
            params_bytes=int(rng.integers(1, 10**5)),
            request_id=None if rng.random() < 0.1 else int(rng.integers(0, n // 2)),
            queue_wait_s=None if rng.random() < 0.05 else float(rng.exponential(0.2)),
            service_s=0.0 if hit and rng.random() < 0.5 else float(rng.exponential(0.5)),
            batch_size=int(rng.integers(1, 5)),
            priority_class=(None, "interactive", "batch", "research")[rng.integers(4)],
            demoted=bool(rng.random() < 0.1),
            cache_hit=hit,
            replica_id=None if rng.random() < 0.2 else int(rng.integers(0, 4)),
            attempt=int(rng.integers(0, 3)),
            extra={"negative_cache": True} if hit and rng.random() < 0.3 else {},
        ))
    return out


def _records(seed: int):
    fields = _fields(seed)
    ours = [record.TelemetryRecord(times=record.StageTimes(), **f) for f in fields]
    theirs = [ref_record.TelemetryRecord(times=ref_record.StageTimes(), **f) for f in fields]
    return ours, theirs


def _rows(summaries) -> list[str]:
    return [s.row() for s in summaries]


@pytest.mark.parametrize("seed", [0, 1])
def test_rollups_equal_the_references(seed):
    ours, theirs = _records(seed)
    assert _rows(analysis.class_summary(ours)) == _rows(ref_analysis.class_summary(theirs))
    assert _rows(analysis.replica_summary(ours)) == _rows(ref_analysis.replica_summary(theirs))
    assert _rows(analysis.precision_summary(ours)) == _rows(ref_analysis.precision_summary(theirs))
    assert analysis.resilience_summary(ours).row() == ref_analysis.resilience_summary(theirs).row()
    stats = {"stores": 7, "quarantines": 1}
    got, expect = analysis.cache_summary(ours, stats), ref_analysis.cache_summary(theirs, stats)
    assert got.row() == expect.row() and got.store_stats == expect.store_stats
    slo = {"interactive": 0.5, "batch": 2.0}
    assert analysis.slo_attainment(ours, slo) == ref_analysis.slo_attainment(theirs, slo)
    # the rollups see every cell the log holds
    assert {(s.executor, s.precision) for s in analysis.precision_summary(ours)} >= {("cuda_megakernel", "int8w")}


@pytest.mark.parametrize("q", [0, 1, 50, 99, 100])
def test_nearest_rank(q):
    values = list(np.random.default_rng(3).exponential(size=37))
    assert analysis.nearest_rank(values, q) == ref_analysis.nearest_rank(values, q)
    assert analysis.nearest_rank([], q) == 0.0


@pytest.mark.parametrize("table", [(120, 30, 90, 60), (5, 0, 7, 0), (0, 10, 0, 12), (1000, 3, 990, 13)])
def test_contingency(table):
    got, expect = analysis.contingency(*table), ref_analysis.contingency(*table)
    assert got.summary() == expect.summary()
    np.testing.assert_array_equal(got.table, expect.table)
    assert (got.chi2, got.p_value, got.power) == (expect.chi2, expect.p_value, expect.power)


def test_causal_estimates():
    rng = np.random.default_rng(4)
    n = 500
    confounders = rng.standard_normal((n, 2))
    treatment = (rng.random(n) < 1 / (1 + np.exp(-confounders[:, 0]))).astype(float)
    outcome = (rng.random(n) < 0.5 + 0.2 * treatment - 0.1 * (confounders[:, 1] > 0)).astype(float)
    assert analysis.iptw_ate(treatment, outcome, confounders) == ref_analysis.iptw_ate(treatment, outcome, confounders)
    assert analysis.regression_adjustment(treatment, outcome, confounders) == ref_analysis.regression_adjustment(
        treatment, outcome, confounders)


def test_the_constants_are_the_references():
    assert analysis.SHED_TYPES == ref_analysis.SHED_TYPES
    assert analysis.FAULT_TYPES == ref_analysis.FAULT_TYPES
    assert analysis.RETRYABLE_TYPES == ref_analysis.RETRYABLE_TYPES
