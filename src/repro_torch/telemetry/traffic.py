"""Modeled device-memory bytes of one MeshNet forward, per executor.

The port's own models of its Hopper schedules (counterpart of
``repro/telemetry/traffic.py``, whose TPU models they do not copy). A
model counts the bytes a schedule moves between device memory and the
SMs, at fp32, the only precision ported. The executor registry wires them
to its specs (core/executors.py), and ``pipeline.run`` stamps the result
on ``TelemetryRecord.hbm_bytes_modeled``.
"""

from __future__ import annotations

import math
from typing import Sequence

from repro_torch.kernels import megakernel, quantize

Shape3 = Sequence[int]


def meshnet_fused_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """K1's per-layer schedule (``ops.meshnet_apply``): each layer reads its
    input and writes its output once, and reads its weights, bias, scale
    and offset once a launch; then the head reads the last activation and
    writes the logits. No padded copy: K1 masks the edges itself."""
    b = quantize.act_bytes(precision)
    v = math.prod(int(s) for s in vol)
    c = cfg.channels
    total = 0
    cin = cfg.in_channels
    for _ in cfg.dilations:
        total += batch * v * (cin + c) * b + (27 * cin * c + 3 * c) * b
        cin = c
    total += batch * v * (c + cfg.num_classes) * b + (c + 1) * cfg.num_classes * b
    return total


def meshnet_megakernel_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """K2's depth-first schedule (``ops.meshnet_apply_megakernel``): the
    planner's own model, ``MegakernelPlan.hbm_bytes``, of the plan the
    forward runs for this volume and batch. Raises ValueError when no plan
    fits one block's shared memory."""
    pln = megakernel.plan_for_config(cfg, tuple(int(s) for s in vol), precision=precision, batch=batch)
    return pln.hbm_bytes(batch)
