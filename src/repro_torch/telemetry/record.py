"""Telemetry records — the schema of the paper's Tables III/IV.

The port's own copy of ``repro/telemetry/record.py``, with the same
columns, so the two packages' records compare field for field. Stage
times are host seconds around work that the pipeline synchronises on the
card before reading the clock.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class StageTimes:
    """Per-stage wall times in seconds (Table IV columns)."""

    preprocessing: float = 0.0
    cropping: float = 0.0
    inference: float = 0.0
    merging: float = 0.0
    postprocessing: float = 0.0

    def total(self) -> float:
        return (
            self.preprocessing
            + self.cropping
            + self.inference
            + self.merging
            + self.postprocessing
        )


@dataclasses.dataclass
class TelemetryRecord:
    model: str
    mode: str  # full | subvolume | streaming
    status: str  # ok | fail
    times: StageTimes
    # which forward backend ran (core/executors.py): torch | cuda_fused |
    # cuda_megakernel | streaming —
    # the server-side analogue of the paper logging the WebGL vs WASM
    # backend per run.
    executor: Optional[str] = None
    # modeled device-memory bytes the executor's schedule moves for this
    # run's inference (telemetry/traffic.py), at the run's precision.
    hbm_bytes_modeled: Optional[int] = None
    # modeled inter-device bytes of the run's halo exchanges — 0 for the
    # single-device executors the port has so far.
    collective_bytes_modeled: Optional[int] = None
    # storage policy the forward ran under (kernels/quantize.py): fp32 |
    # bf16 | int8w; the modeled bytes above are priced at its widths.
    precision: Optional[str] = None
    # bytes of the weight tree the executor streams
    # (quantize.model_params_bytes).
    params_bytes: Optional[int] = None
    fail_type: Optional[str] = None
    crop_size: Optional[tuple] = None
    # device context (the simulator's stand-ins for GPU card / texture size)
    memory_budget_bytes: Optional[int] = None
    # ---- serving-path fields (serving/scheduler.py) --------------------
    # Stamped by the request scheduler on queued requests; None on direct
    # pipeline runs. Under the deterministic load simulator these are
    # *virtual-clock* seconds (serving/simulator.py), which is what makes
    # the fleet latency rollups bit-reproducible in CI.
    request_id: Optional[int] = None
    # arrival time of the request on the scheduler's clock
    arrival_s: Optional[float] = None
    # time spent queued before its batch started service
    queue_wait_s: Optional[float] = None
    # modeled (virtual clock) or measured (real clock) service time
    service_s: Optional[float] = None
    # how many requests shared this request's dispatch group (>= 1)
    batch_size: Optional[int] = None
    # admission class the scheduler served it under
    priority_class: Optional[str] = None
    # True when HBM-budget admission shed the request to the sub-volume
    # failsafe (the paper's patching intervention, applied as backpressure)
    demoted: bool = False
    # True when the content-addressed artifact cache (serving/cache.py)
    # served this request in O(hash) without touching a device — the
    # record's service_s is the cache lookup+verify cost, not a forward.
    # Coalesced followers of a single-flight leader are also stamped True.
    cache_hit: bool = False
    # which fleet replica served (or shed) the request — stamped by the
    # fleet layer (serving/fleet.py); None outside fleet serving. A
    # request re-dispatched after a replica crash carries the replica
    # that finally SERVED it, never the one that lost it.
    replica_id: Optional[int] = None
    # which service attempt this record describes (0 = first try): the
    # resilience layer (serving/resilience.py) re-serves retryable
    # faults, and every attempt emits its own record — grouping on
    # (replica_id, request_id) and taking the last attempt reconstructs
    # each request's terminal state from the stream alone.
    attempt: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d)


class TelemetryLog:
    """Append-only JSONL log + in-memory list (the 1336-sample dataset
    analogue)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: list[TelemetryRecord] = []

    def append(self, rec: TelemetryRecord) -> None:
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(rec.to_json() + "\n")

    def success_rate(self) -> float:
        if not self.records:
            return 0.0
        ok = sum(1 for r in self.records if r.status == "ok")
        return ok / len(self.records)

    def by(self, key) -> dict:
        out: dict = {}
        for r in self.records:
            out.setdefault(key(r), []).append(r)
        return out
