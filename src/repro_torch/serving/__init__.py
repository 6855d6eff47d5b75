"""Serving tier: the engines (engine.py), the typed serving errors
(errors.py), the continuous-batching request scheduler (scheduler.py) and
the deterministic load simulator (simulator.py). The resilience layer,
the artifact cache and the replicated fleet are not ported yet (ROADMAP.md,
Queue 1 items 13b and 13c)."""

from repro_torch.serving.errors import (  # noqa: F401
    EXECUTION_FAULT_TYPES,
    PERMANENT_FAULT,
    RETRYABLE_FAIL_TYPES,
    SERVICE_TIMEOUT,
    TRANSIENT_FAULT,
    CacheCorruptionError,
    CacheFault,
    CacheUnavailableError,
    ExecutorFault,
    FleetConfigError,
    NoReplicaAvailable,
    PermanentExecutorError,
    QueueFullError,
    ResilienceConfigError,
    ServingError,
    TransientExecutorError,
    classify,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    DEFAULT_CLASSES,
    PriorityClass,
    RequestScheduler,
    SchedulerConfig,
)
from repro_torch.serving.simulator import (  # noqa: F401
    ScenarioSpec,
    ServiceModel,
    SimConfig,
    VirtualClock,
    preset,
    simulate,
)
