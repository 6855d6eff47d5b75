"""Statistical analysis of telemetry: the port's copy of
``repro/telemetry/analysis.py``, over the port's ``TelemetryRecord``.

The paper's section IV toolkit over simulated fleet telemetry: success-rate
contingency tables, the Chi-square test for independence with its power,
and IPTW (inverse probability of treatment weighting) and regression
estimates of the patching, cropping and texture-size interventions; and
the serving rollups by priority class, replica, resilience, cache and
(executor, precision) cell. numpy and scipy only; every summary's
``row()`` is a stable CSV string, equal to the reference's on the same
records.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import stats


@dataclasses.dataclass
class ContingencyResult:
    table: np.ndarray  # 2x2 [treatment x outcome]
    chi2: float
    p_value: float
    success_rate_treated: float
    success_rate_control: float
    power: float

    def summary(self) -> str:
        return (
            f"chi2={self.chi2:.3f} p={self.p_value:.2e} "
            f"SR(treated)={self.success_rate_treated*100:.2f}% "
            f"SR(control)={self.success_rate_control*100:.2f}% power={self.power:.3f}"
        )


def contingency(treated_ok: int, treated_fail: int, control_ok: int, control_fail: int,
                alpha: float = 0.05) -> ContingencyResult:
    """Chi-square test for a 2x2 treatment/outcome table + power analysis
    (the paper: power 0.963 at alpha 0.05 for the full dataset)."""
    table = np.array([[treated_ok, treated_fail], [control_ok, control_fail]], float)
    if (table.sum(0) == 0).any() or (table.sum(1) == 0).any():
        # Degenerate margin (e.g. zero successes in both arms): no evidence.
        tr = treated_ok / max(treated_ok + treated_fail, 1)
        cr = control_ok / max(control_ok + control_fail, 1)
        return ContingencyResult(table, 0.0, 1.0, tr, cr, 0.0)
    chi2, p, _, _ = stats.chi2_contingency(table, correction=False)
    n = table.sum()
    w = math.sqrt(chi2 / n)  # effect size (phi)
    # power of chi-square test with df=1 at this effect size and sample size
    nc = n * w * w  # noncentrality
    crit = stats.chi2.ppf(1 - alpha, df=1)
    power = 1 - stats.ncx2.cdf(crit, df=1, nc=max(nc, 1e-9))
    tr = treated_ok / max(treated_ok + treated_fail, 1)
    cr = control_ok / max(control_ok + control_fail, 1)
    return ContingencyResult(table, float(chi2), float(p), tr, cr, float(power))


def iptw_ate(treatment: np.ndarray, outcome: np.ndarray, confounders: np.ndarray) -> float:
    """IPTW Average Treatment Effect:
        ATE = E[Y | do(T=1)] - E[Y | do(T=0)]
    with propensity scores from a logistic regression of T on confounders
    (fitted by Newton iterations — no sklearn dependency).
    """
    X = np.column_stack([np.ones(len(treatment)), confounders])
    beta = np.zeros(X.shape[1])
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-X @ beta))
        W = p * (1 - p) + 1e-6
        grad = X.T @ (treatment - p)
        hess = (X * W[:, None]).T @ X + 1e-6 * np.eye(X.shape[1])
        step = np.linalg.solve(hess, grad)
        beta += step
        if np.abs(step).max() < 1e-8:
            break
    p = np.clip(1.0 / (1.0 + np.exp(-X @ beta)), 1e-3, 1 - 1e-3)
    w1 = treatment / p
    w0 = (1 - treatment) / (1 - p)
    ate = (w1 * outcome).sum() / w1.sum() - (w0 * outcome).sum() / w0.sum()
    return float(ate)


def regression_adjustment(treatment, outcome, confounders) -> float:
    """OLS effect of treatment on outcome controlling for confounders
    (the paper's 'regression adjustment' patching estimate)."""
    X = np.column_stack([np.ones(len(treatment)), treatment, confounders])
    coef, *_ = np.linalg.lstsq(X, outcome, rcond=None)
    return float(coef[1])


@dataclasses.dataclass
class PrecisionSummary:
    """Aggregate of one (executor, precision) serving cell."""

    executor: str
    precision: str
    runs: int
    ok_rate: float
    mean_hbm_bytes: float  # modeled, per run (0 when unmodeled)
    mean_collective_bytes: float
    mean_params_bytes: float

    def row(self) -> str:
        return (
            f"{self.executor},{self.precision},{self.runs},"
            f"{self.ok_rate:.3f},{self.mean_hbm_bytes:.0f},"
            f"{self.mean_collective_bytes:.0f},{self.mean_params_bytes:.0f}"
        )


@dataclasses.dataclass
class ClassSummary:
    """Aggregate of one serving priority class over scheduler-stamped
    telemetry (TelemetryRecord.priority_class etc., serving/scheduler.py).
    Times are whatever clock stamped the records — virtual seconds under
    the load simulator (deterministic), wall seconds in production."""

    priority_class: str
    requests: int
    served: int  # reached service (completed or demoted)
    demoted: int
    shed: dict  # typed pre-service rejections: fail_type -> count
    ok_rate: float  # of served requests
    p50_wait_s: float
    p99_wait_s: float
    p50_service_s: float
    p99_service_s: float
    mean_batch_size: float

    def row(self) -> str:
        return (
            f"{self.priority_class},{self.requests},{self.served},"
            f"{self.demoted},{sum(self.shed.values())},{self.ok_rate:.3f},"
            f"{self.p50_wait_s:.4f},{self.p99_wait_s:.4f},"
            f"{self.p50_service_s:.4f},{self.p99_service_s:.4f},"
            f"{self.mean_batch_size:.2f}"
        )


#: pre-service shed reasons the scheduler emits (vs execution failures).
SHED_TYPES = ("queue_full", "deadline_expired", "admission_oom")


def nearest_rank(values, q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation) — THE
    percentile of the serving stack: class_summary, the load simulator's
    summaries, and the golden serving traces all use this one function,
    so their numbers stay byte-stable and mutually consistent."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[rank - 1])


def class_summary(records) -> list[ClassSummary]:
    """Per-priority-class queue/latency rollup over a telemetry log — the
    serving-tier SLO view: how long each class waited, how long service
    took, how much was demoted or shed. Records without a
    ``priority_class`` stamp (direct pipeline runs) are skipped. Sorted
    by class name for stable output."""
    by: dict[str, list] = {}
    for r in records:
        if r.priority_class is not None:
            by.setdefault(r.priority_class, []).append(r)
    out = []
    for name in sorted(by):
        rs = by[name]
        shed = {
            t: sum(1 for r in rs if r.fail_type == t)
            for t in SHED_TYPES
            if any(r.fail_type == t for r in rs)
        }
        served = [r for r in rs if r.fail_type not in SHED_TYPES]
        # wait percentiles over SERVED requests only: queue-full refusals
        # are stamped with zero wait at submit time and would drag the
        # percentiles down exactly when overload makes them matter
        waits = [r.queue_wait_s for r in served if r.queue_wait_s is not None]
        services = [r.service_s for r in served if r.service_s is not None]
        batches = [r.batch_size for r in served if r.batch_size is not None]
        out.append(
            ClassSummary(
                priority_class=name,
                requests=len(rs),
                served=len(served),
                demoted=sum(1 for r in served if r.demoted),
                shed=shed,
                ok_rate=sum(1 for r in served if r.status == "ok")
                / max(len(served), 1),
                p50_wait_s=nearest_rank(waits, 50),
                p99_wait_s=nearest_rank(waits, 99),
                p50_service_s=nearest_rank(services, 50),
                p99_service_s=nearest_rank(services, 99),
                mean_batch_size=float(np.mean(batches)) if batches else 0.0,
            )
        )
    return out


def slo_attainment(records, slo_s: dict) -> dict:
    """Fraction of each class's requests that got a SUCCESSFUL answer
    within the class's SLO bound, end to end (``queue_wait_s +
    service_s`` — the scheduler stamps wait up to the member's own
    service start, so the sum is exactly finish - arrival even deep
    inside a batch). Classes without a bound in ``slo_s`` are omitted;
    shed requests AND failed runs count as misses — either way the user
    spent their patience without an answer."""
    out: dict[str, float] = {}
    for s in class_summary(records):
        bound = slo_s.get(s.priority_class)
        if bound is None:
            continue
        rs = [r for r in records if r.priority_class == s.priority_class]
        met = sum(
            1
            for r in rs
            if r.status == "ok"
            and r.queue_wait_s is not None
            and r.service_s is not None
            and (r.queue_wait_s + r.service_s) <= bound
        )
        out[s.priority_class] = met / max(len(rs), 1)
    return out


@dataclasses.dataclass
class ReplicaSummary:
    """Aggregate of one fleet replica over replica-stamped telemetry
    (TelemetryRecord.replica_id, serving/fleet.py) — the per-server view
    of the fleet rollup: how much each replica served, how well, and how
    long its queue ran."""

    replica_id: int
    requests: int
    served: int  # reached service on this replica (completed or demoted)
    demoted: int
    shed: dict  # typed pre-service rejections on this replica
    ok_rate: float  # of served requests
    p50_wait_s: float
    p99_wait_s: float
    mean_batch_size: float

    def row(self) -> str:
        return (
            f"{self.replica_id},{self.requests},{self.served},{self.demoted},"
            f"{sum(self.shed.values())},{self.ok_rate:.3f},"
            f"{self.p50_wait_s:.4f},{self.p99_wait_s:.4f},{self.mean_batch_size:.2f}"
        )


def replica_summary(records) -> list[ReplicaSummary]:
    """Per-replica queue/latency rollup over a fleet telemetry stream —
    the horizontal cut ``class_summary`` doesn't see: a hot replica hides
    inside healthy fleet-wide percentiles, but not inside its own row.
    Records without a ``replica_id`` stamp (single-server or direct
    pipeline runs) are skipped. Sorted by replica id for stable output."""
    by: dict[int, list] = {}
    for r in records:
        if r.replica_id is not None:
            by.setdefault(r.replica_id, []).append(r)
    out = []
    for rid in sorted(by):
        rs = by[rid]
        shed = {
            t: sum(1 for r in rs if r.fail_type == t)
            for t in SHED_TYPES
            if any(r.fail_type == t for r in rs)
        }
        served = [r for r in rs if r.fail_type not in SHED_TYPES]
        waits = [r.queue_wait_s for r in served if r.queue_wait_s is not None]
        batches = [r.batch_size for r in served if r.batch_size is not None]
        out.append(
            ReplicaSummary(
                replica_id=rid,
                requests=len(rs),
                served=len(served),
                demoted=sum(1 for r in served if r.demoted),
                shed=shed,
                ok_rate=sum(1 for r in served if r.status == "ok")
                / max(len(served), 1),
                p50_wait_s=nearest_rank(waits, 50),
                p99_wait_s=nearest_rank(waits, 99),
                mean_batch_size=float(np.mean(batches)) if batches else 0.0,
            )
        )
    return out


#: execution-fault fail_types the reference's resilience layer stamps
#: (its serving/errors.py), as strings: the port's records carry the same
#: names.
FAULT_TYPES = ("transient_fault", "permanent_fault", "service_timeout")
#: the retryable subset — the recovery denominator: permanent faults are
#: unrecoverable BY DESIGN (the ladder routes around them instead), so
#: they must not dilute the retry layer's recovery rate.
RETRYABLE_TYPES = ("transient_fault", "service_timeout")


@dataclasses.dataclass
class ResilienceSummary:
    """Aggregate of the resilience layer's attempt stream — reconstructed
    from telemetry alone (TelemetryRecord.attempt, serving/errors.py fail
    types): every service attempt emits its own record, so grouping on
    (replica_id, request_id) and taking the highest attempt recovers each
    request's terminal state without consulting the scheduler."""

    requests: int  # scheduler-stamped requests seen (unique ids)
    attempts: int  # service-attempt records (>= requests)
    retries: int  # attempts beyond each request's first
    faults: dict  # fail_type -> attempt count, over FAULT_TYPES
    faulted_requests: int  # requests with >= 1 RETRYABLE faulted attempt
    recovered_requests: int  # faulted requests whose terminal attempt is ok
    recovery_rate: float  # recovered / faulted (1.0 when nothing faulted)

    def row(self) -> str:
        return (
            f"{self.requests},{self.attempts},{self.retries},"
            f"{sum(self.faults.values())},{self.faulted_requests},"
            f"{self.recovered_requests},{self.recovery_rate:.3f}"
        )


def resilience_summary(records) -> ResilienceSummary:
    """Fault/retry/recovery rollup over a telemetry log — the analysis
    face of serving/resilience.py. Records without a ``request_id`` stamp
    (direct pipeline runs) are skipped; pre-service sheds (``SHED_TYPES``)
    are not attempts and are skipped too."""
    by: dict[tuple, list] = {}
    for r in records:
        if r.request_id is None or r.fail_type in SHED_TYPES:
            continue
        by.setdefault((r.replica_id, r.request_id), []).append(r)
    attempts = sum(len(rs) for rs in by.values())
    faults = {
        t: sum(1 for rs in by.values() for r in rs if r.fail_type == t)
        for t in FAULT_TYPES
    }
    faulted = recovered = 0
    for rs in by.values():
        if not any(r.fail_type in RETRYABLE_TYPES for r in rs):
            continue
        faulted += 1
        terminal = max(rs, key=lambda r: r.attempt)
        if terminal.status == "ok":
            recovered += 1
    return ResilienceSummary(
        requests=len(by),
        attempts=attempts,
        retries=attempts - len(by),
        faults=faults,
        faulted_requests=faulted,
        recovered_requests=recovered,
        recovery_rate=recovered / faulted if faulted else 1.0,
    )


@dataclasses.dataclass
class CacheSummary:
    """Aggregate of the artifact-cache tier as seen from telemetry alone
    (TelemetryRecord.cache_hit, serving/cache.py): every cache-served
    answer carries the ``cache_hit`` stamp, admission hits pay the verify
    service, and coalesced followers ride their leader's record with
    zero service — so the split is recoverable without the cache object.
    Pass the cache's own ``summary()`` dict as ``store_stats`` to merge
    the store-side ledger (stores / quarantines / evictions / breaker)."""

    requests: int  # scheduler-stamped records seen
    cache_served: int  # records answered from the cache tier
    admission_hits: int  # clean artifact (or negative) hits at admission
    coalesced: int  # followers collapsed onto an in-flight leader
    negative_serves: int  # known-permanent failures answered from cache
    computed: int  # everything else — requests that touched the device
    cache_served_rate: float  # cache_served / requests
    store_stats: dict  # the cache's own counter ledger ({} if not given)

    def row(self) -> str:
        return (
            f"{self.requests},{self.cache_served},{self.admission_hits},"
            f"{self.coalesced},{self.negative_serves},{self.computed},"
            f"{self.cache_served_rate:.3f}"
        )


def cache_summary(records, store_stats: dict | None = None) -> CacheSummary:
    """Cache-tier rollup over a telemetry log — the analysis face of
    serving/cache.py. Records without a ``request_id`` stamp (direct
    pipeline runs) are skipped, as are pre-service sheds (``SHED_TYPES``
    — a refused request never consulted the cache's serving path).
    Coalesced followers are the cache-hit records with exactly zero
    service: the leader's artifact was handed over at completion time,
    no verify read was paid. ``store_stats`` (an
    ``ArtifactCache.summary()`` dict) is attached verbatim when given —
    counters like quarantines and evictions live only in the store."""
    rs = [
        r
        for r in records
        if r.request_id is not None and r.fail_type not in SHED_TYPES
    ]
    served = [r for r in rs if r.cache_hit]
    coalesced = sum(1 for r in served if r.service_s == 0.0)
    negative = sum(
        1 for r in served if r.extra is not None and r.extra.get("negative_cache")
    )
    return CacheSummary(
        requests=len(rs),
        cache_served=len(served),
        admission_hits=len(served) - coalesced,
        coalesced=coalesced,
        negative_serves=negative,
        computed=len(rs) - len(served),
        cache_served_rate=len(served) / max(len(rs), 1),
        store_stats=dict(store_stats) if store_stats else {},
    )


def precision_summary(records) -> list[PrecisionSummary]:
    """Per-(executor, precision) traffic/footprint aggregates over a
    telemetry log — the fleet view of the precision policy: which backend
    ran at which storage policy, how often it succeeded, and the modeled
    HBM / collective / weight bytes it moved (TelemetryRecord.precision
    and .params_bytes, stamped by core/pipeline.py). Sorted by descending
    run count so the dominant serving cell leads."""
    cells: dict = {}
    for r in records:
        key = (r.executor or "?", r.precision or "fp32")
        cells.setdefault(key, []).append(r)
    out = []
    for (executor, precision), rs in cells.items():
        ok = sum(1 for r in rs if r.status == "ok")
        out.append(
            PrecisionSummary(
                executor=executor,
                precision=precision,
                runs=len(rs),
                ok_rate=ok / len(rs),
                mean_hbm_bytes=float(
                    np.mean([r.hbm_bytes_modeled or 0 for r in rs])
                ),
                mean_collective_bytes=float(
                    np.mean([r.collective_bytes_modeled or 0 for r in rs])
                ),
                mean_params_bytes=float(
                    np.mean([r.params_bytes or 0 for r in rs])
                ),
            )
        )
    return sorted(out, key=lambda s: -s.runs)
