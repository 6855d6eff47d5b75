"""Segmentation serving engine — counterpart of ``SegmentationEngine`` in
``repro/serving/engine.py``.

Picks full-volume streaming vs the sub-volume failsafe per request from
the memory budget (one H100's device memory by default), runs the
pipeline on the engine's device, and logs each request's telemetry.
The queued entry points (``submit_async``, ``drain``, ``submit_many``)
come with the scheduler slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch import resolve_device
from repro_torch.core import pipeline as pl
from repro_torch.kernels import quantize
from repro_torch.telemetry.budget import BudgetExceeded, MemoryBudget
from repro_torch.telemetry.record import TelemetryLog


class SegmentationEngine:
    """Server-side Brainchop on one device (``device=None``: the CUDA card,
    which must exist). ``params`` and the mask model's params must already
    be on that device. ``precision`` is the engine's default storage policy
    ("auto" resolves to fp32 in the port). The slab count of the
    reference's sharded executors stays on ``PipelineConfig.shard_devices``
    until the multi-GPU slice."""

    def __init__(
        self,
        params,
        pipeline_cfg: pl.PipelineConfig,
        *,
        mask_model=None,
        budget: Optional[MemoryBudget] = None,
        precision: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = pipeline_cfg
        self.mask_model = mask_model
        self.budget = budget or MemoryBudget.h100()
        self.precision = precision or pipeline_cfg.precision
        self.log = TelemetryLog()

    def _params_for(self, precision: str):
        """The weight tree in ``precision`` storage: fp32, the only policy
        ported so far, is the tree as given."""
        quantize.resolve_precision(precision, self.cfg.model)
        return self.params

    def pick_mode(self, volume_shape, precision: Optional[str] = None) -> str:
        """Budget-driven failsafe selection at the request's precision:
        "streaming" when two live activations fit, else "subvolume"."""
        resolved = quantize.resolve_precision(precision or self.precision, self.cfg.model)
        try:
            self.budget.charge_streaming(
                volume_shape, self.cfg.model, dtype_bytes=quantize.act_bytes(resolved)
            )
            return "streaming"
        except BudgetExceeded:
            return "subvolume"

    def submit(
        self,
        vol,
        *,
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        precision: Optional[str] = None,
    ) -> pl.PipelineResult:
        """Run one volume synchronously; the keyword arguments override the
        engine's defaults for this request only."""
        return self._run_request(vol, mode=mode, executor=executor, precision=precision)

    def _run_request(
        self,
        vol,
        *,
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        precision: Optional[str] = None,
    ) -> pl.PipelineResult:
        """Resolve the request's defaults, run the pipeline, log telemetry."""
        prec = precision or self.precision
        mode = mode or self.pick_mode(self.cfg.volume_shape, prec)
        cfg = dataclasses.replace(
            self.cfg,
            mode=mode,
            budget=self.budget,
            executor=executor or self.cfg.executor,
            precision=prec,
        )
        res = pl.run(
            cfg, self._params_for(prec), vol, mask_model=self.mask_model, device=self.device
        )
        self.log.append(res.record)
        return res
