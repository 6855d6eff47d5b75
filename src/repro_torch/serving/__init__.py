"""Serving tier: the engines (engine.py), the typed serving errors
(errors.py), the continuous-batching request scheduler (scheduler.py),
the deterministic load simulator (simulator.py), the replicated fleet
behind a cache-affinity router (fleet.py), the resilience layer —
retry/backoff, timeouts, hedging and the executor degradation ladder
behind circuit breakers (resilience.py) — and the content-addressed
artifact cache with integrity quarantine, single-flight coalescing and a
fail-open breaker (cache.py)."""

from repro_torch.serving.cache import (  # noqa: F401
    ArtifactCache,
    CacheConfig,
    CacheStats,
    ConformMemo,
    artifact_key,
    content_hash,
)
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
from repro_torch.serving.fleet import (  # noqa: F401
    FLEET_PRESETS,
    ROUTER_POLICIES,
    AutoscalerConfig,
    Fleet,
    FleetConfig,
    FleetEvent,
    FleetServiceModel,
    fleet_preset,
    simulate_fleet,
)
from repro_torch.serving.resilience import (  # noqa: F401
    CARD_LADDER,
    FAULT_KINDS,
    LADDER,
    BreakerConfig,
    FaultPlan,
    FaultRule,
    HedgePolicy,
    ResiliencePolicy,
    RetryPolicy,
    SignatureBreaker,
    demote_rung,
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
