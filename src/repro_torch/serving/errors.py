"""Typed fault taxonomy of the serving tier — counterpart of
``repro/serving/errors.py``, class for class.

Every error a scheduler, router or executor can raise is a typed class
defined (or re-exported) here, and execution faults are split along the
one axis that changes scheduling policy: can a retry help?

  * ``TransientExecutorError`` — the fault is expected to clear on its
    own (preemption, an allocation race, a flaky device): a retry policy
    may re-enqueue the request with its original arrival stamp.
  * ``PermanentExecutorError`` — retrying the same signature on the same
    executor reproduces the fault: no retry.

``classify`` maps any raised exception onto that axis. Unknown exceptions
are permanent: retrying an unclassified fault spends capacity exactly
when the service is least healthy. So a CUDA error (a kernel that fails
to build or launch) classifies as ``permanent_fault``, as an XLA error
does in the reference. The scheduler stamps the result as the record's
``fail_type``.

The scheduler's retries, service timeouts and circuit breaker
(serving/resilience.py) act on these types; the artifact cache
(serving/cache.py) raises and degrades on the cache faults.
"""

from __future__ import annotations

# Typed errors owned by other layers, re-exported for one-stop imports:
# the sharded executor family's geometry failures and the memory-budget
# model's admission failures both cross the serving boundary.
from repro_torch.core.spatial_shard import ShardGeometryError  # noqa: F401
from repro_torch.telemetry.budget import BudgetExceeded  # noqa: F401

class ServingError(Exception):
    """Base class of every serving-owned typed error."""


# --------------------------------------------------------- executor faults ---


class ExecutorFault(ServingError):
    """Base of the execution-fault taxonomy: a request reached service
    and the executor raised. Subclasses pick the retry policy."""


class TransientExecutorError(ExecutorFault):
    """A fault expected to clear on retry: device preemption, a device
    memory allocation race, an interrupted halo exchange."""


class PermanentExecutorError(ExecutorFault):
    """A fault that will reproduce on the same (executor, signature):
    retrying is wasted work."""


# ------------------------------------------------------------ cache faults ---


class CacheFault(ServingError):
    """Base of the artifact-cache fault taxonomy. Cache faults are never
    request failures: the cache is an optimization in front of compute,
    so every cache fault degrades fail-open (recompute, or bypass the
    tier)."""


class CacheCorruptionError(CacheFault):
    """An artifact's stored checksum no longer matches its bytes. The
    entry is quarantined and the request recomputed; corrupt bytes must
    never reach a completion."""

    def __init__(self, key: str, expected: str, actual: str):
        super().__init__(
            f"cache artifact {key[:16]}… failed integrity re-verification: "
            f"stored checksum {expected[:12]}… != recomputed {actual[:12]}…"
        )
        self.key = key
        self.expected = expected
        self.actual = actual


class CacheUnavailableError(CacheFault):
    """The cache tier did not answer. The caller serves via compute."""

    def __init__(self, reason: str = "cache tier unavailable"):
        super().__init__(reason)


#: fail_type stamps of the execution-fault taxonomy (TelemetryRecord).
TRANSIENT_FAULT = "transient_fault"
PERMANENT_FAULT = "permanent_fault"
#: a batch member cancelled by its priority class's service timeout,
#: scheduled like a transient fault.
SERVICE_TIMEOUT = "service_timeout"

#: fail types a retry policy treats as retryable.
RETRYABLE_FAIL_TYPES = frozenset({TRANSIENT_FAULT, SERVICE_TIMEOUT})
#: every execution-fault fail_type.
EXECUTION_FAULT_TYPES = frozenset({TRANSIENT_FAULT, PERMANENT_FAULT, SERVICE_TIMEOUT})


def classify(exc: BaseException) -> str:
    """Map a raised exception to its ``fail_type`` stamp. Explicitly
    transient errors (and cache faults, which recompute fixes) are
    ``transient_fault``; everything else — PermanentExecutorError,
    garbage-volume errors, geometry failures, CUDA errors, unknown bugs —
    is ``permanent_fault``.

    ``BaseException``s that are not ``Exception``s — KeyboardInterrupt,
    SystemExit, GeneratorExit — are control flow, not faults: they
    re-raise."""
    if not isinstance(exc, Exception):
        raise exc
    if isinstance(exc, TransientExecutorError):
        return TRANSIENT_FAULT
    if isinstance(exc, CacheFault):
        return TRANSIENT_FAULT
    return PERMANENT_FAULT


# ------------------------------------------------------ admission / router ---


class QueueFullError(ServingError):
    """Typed backpressure: the admission queue is at its depth limit."""

    def __init__(self, depth: int, limit: int):
        super().__init__(f"serving queue full: {depth} queued, limit {limit}")
        self.depth = depth
        self.limit = limit


class NoReplicaAvailable(ServingError):
    """Typed router backpressure: no live, non-draining replica exists to
    take the request."""

    def __init__(self, total: int, draining: int, crashed: int):
        super().__init__(
            f"no routable replica: {total} total, {draining} draining, "
            f"{crashed} crashed"
        )
        self.total = total
        self.draining = draining
        self.crashed = crashed


class FleetConfigError(ValueError):
    """Typed rejection of an unservable fleet configuration (for example
    scale-to-zero)."""


class ResilienceConfigError(ValueError):
    """Typed rejection of an unservable resilience configuration."""
