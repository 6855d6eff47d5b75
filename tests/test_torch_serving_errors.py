"""serving/errors.py of the port against the reference's: the same
classes, the same fail-type stamps, the same classification, and the
re-exports taken from the port's own layers."""

import pytest
import torch

import repro.serving.errors as ref_errors
from repro_torch.core import spatial_shard
from repro_torch.serving import errors
from repro_torch.telemetry import budget

CLASSES = [
    "ServingError", "ExecutorFault", "TransientExecutorError", "PermanentExecutorError", "CacheFault",
    "CacheCorruptionError", "CacheUnavailableError", "QueueFullError", "NoReplicaAvailable",
    "FleetConfigError", "ResilienceConfigError",
]


@pytest.mark.parametrize("name", CLASSES)
def test_class_hierarchy_matches_the_reference(name):
    ours, theirs = getattr(errors, name), getattr(ref_errors, name)
    assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in theirs.__mro__]


@pytest.mark.parametrize(
    "name", ["TRANSIENT_FAULT", "PERMANENT_FAULT", "SERVICE_TIMEOUT", "RETRYABLE_FAIL_TYPES", "EXECUTION_FAULT_TYPES"]
)
def test_fail_type_stamps_match_the_reference(name):
    assert getattr(errors, name) == getattr(ref_errors, name)


def _cases(mod):
    return [
        mod.TransientExecutorError("blip"),
        mod.PermanentExecutorError("poison"),
        mod.CacheCorruptionError("k" * 32, "a" * 16, "b" * 16),
        mod.CacheUnavailableError(),
        ValueError("garbage volume"),
        RuntimeError("CUDA error: an illegal memory access was encountered"),
        mod.QueueFullError(3, 3),
        KeyError("executor"),
    ]


def test_classify_matches_the_reference():
    got = [errors.classify(e) for e in _cases(errors)]
    assert got == [ref_errors.classify(e) for e in _cases(ref_errors)]
    t, p = "transient_fault", "permanent_fault"
    assert got == [t, p, t, t, p, p, p, p]


def test_a_cuda_error_is_permanent():
    """Anything not explicitly transient is permanent: a kernel that fails
    to build or launch raises RuntimeError (torch.cuda's errors among
    them) and is never retried."""
    assert errors.classify(torch.cuda.OutOfMemoryError("out of memory")) == errors.PERMANENT_FAULT
    assert errors.classify(RuntimeError("nvcc failed")) == errors.PERMANENT_FAULT


@pytest.mark.parametrize("exc", [KeyboardInterrupt(), SystemExit(0), GeneratorExit()])
def test_control_flow_is_not_a_fault(exc):
    with pytest.raises(type(exc)):
        errors.classify(exc)


def test_reexports_are_the_ports_own():
    assert errors.ShardGeometryError is spatial_shard.ShardGeometryError
    assert errors.BudgetExceeded is budget.BudgetExceeded


def test_messages_and_fields_match_the_reference():
    pairs = [
        (errors.QueueFullError(5, 4), ref_errors.QueueFullError(5, 4)),
        (errors.NoReplicaAvailable(3, 1, 2), ref_errors.NoReplicaAvailable(3, 1, 2)),
        (errors.CacheCorruptionError("k" * 32, "a" * 16, "b" * 16), ref_errors.CacheCorruptionError("k" * 32, "a" * 16, "b" * 16)),
        (errors.CacheUnavailableError(), ref_errors.CacheUnavailableError()),
    ]
    for ours, theirs in pairs:
        assert str(ours) == str(theirs)
        assert vars(ours) == vars(theirs)
