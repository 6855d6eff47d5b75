"""Modeled device-memory bytes of one MeshNet forward, per executor.

The port's own models of its Hopper schedules (counterpart of
``repro/telemetry/traffic.py``, whose TPU models they do not copy, but
for the schedules that are the same stages on both: the plain forward's
and the streaming schedule's, and the megakernel's, which prices the
reference's formula on the port's own plan). A model counts the bytes a
schedule moves between device memory and the SMs, each tensor at its
role's width under the precision policy (kernels/quantize.py:
activations 4 or 2 bytes, conv weights 4, 2 or 1, the megakernel's input
and staging arrays down to 1 under int8w, biases, BN vectors and scales
4). A batched forward (``batch=N``) moves each data tensor once a member
and each weight tensor once a launch, so ``bytes(batch=N) < N *
bytes(batch=1)``. ``EXECUTOR_MODELS`` maps each executor to its model;
the executor registry wires them to its specs (core/executors.py), and
``pipeline.run`` stamps the result on ``TelemetryRecord.hbm_bytes_modeled``.
The sharded family (core/spatial_shard.py) prices its halo traffic between
devices with ``meshnet_collective_bytes`` (stamped on
``collective_bytes_modeled``) and its device-memory traffic with
``meshnet_sharded_bytes``: the reference's conventions, over the port's
inner models.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.kernels import megakernel, quantize

Shape3 = Sequence[int]


def meshnet_plain_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """The ``torch`` executor's plain forward (``meshnet.apply``;
    ``quantize.reference_apply`` at a reduced policy), the reference's
    model of its ``xla`` graph, which is the same stages: each layer a
    conv at its traffic floor (read its input once, write its output
    once), then BatchNorm and ReLU as materialised stages, each a read
    and a write of the activation; then the 1x1x1 head. Its weights are
    read once a launch."""
    ab, wb = quantize.act_bytes(precision), quantize.weight_bytes(precision)
    v = math.prod(int(s) for s in vol)
    c = cfg.channels
    stages = 3 if cfg.use_batchnorm else 2  # conv, (BatchNorm,) ReLU
    data = weights = 0
    cin = cfg.in_channels
    for _ in cfg.dilations:
        data += v * (cin + c) * ab
        data += (stages - 1) * 2 * v * c * ab
        weights += 27 * cin * c * wb
        cin = c
    data += v * (c + cfg.num_classes) * ab
    return batch * data + weights


def meshnet_views_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """K5's 27-view schedule (``dilated_conv3d(variant="views")``,
    ``csrc/dilated_conv3d_views.cu``) a layer, then the head as the fused
    forward's: per output tile of 8^3 every one of the 27 taps stages its
    shifted 8^3 x Cin input tile (27 x the compulsory input bytes), the
    tile's output is written once, and the block stages the layer's
    weights, bias, scale and offset (per spatial tile; a batch member's
    block finds them in the same launch)."""
    ab, wb = quantize.act_bytes(precision), quantize.weight_bytes(precision)
    b = 8  # csrc/dilated_conv3d_views.cu's tile
    v = math.prod(int(s) for s in vol)
    ntiles = math.prod(-(-int(s) // b) for s in vol)
    c = cfg.channels
    data = weights = 0
    cin = cfg.in_channels
    for _ in cfg.dilations:
        data += ntiles * 27 * b**3 * cin * ab + v * c * ab
        weights += ntiles * (27 * cin * c * wb + 3 * c * 4)
        cin = c
    data += v * (c + cfg.num_classes) * ab
    weights += c * cfg.num_classes * ab + cfg.num_classes * 4
    return batch * data + weights


def meshnet_fused_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """K1's (K1r's) per-layer schedule (``ops.meshnet_apply``): each layer
    reads its input and writes its output once, and reads its weights,
    bias, scale and offset once a launch; then the head reads the last
    activation and its weights and bias and writes the logits. No padded
    copy: the kernel masks the edges itself. The input is priced at the
    activation width, as the forward casts it first."""
    ab, wb = quantize.act_bytes(precision), quantize.weight_bytes(precision)
    hb = ab  # the head's weight: fp32 or bf16
    v = math.prod(int(s) for s in vol)
    c = cfg.channels
    data = weights = 0
    cin = cfg.in_channels
    for _ in cfg.dilations:
        data += v * (cin + c) * ab
        weights += 27 * cin * c * wb + 3 * c * 4
        cin = c
    data += v * (c + cfg.num_classes) * ab
    weights += c * cfg.num_classes * hb + cfg.num_classes * 4
    return batch * data + weights


def meshnet_streaming_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """The streaming schedule (``core/streaming.py``), the reference's
    model of the same stages: a memory-floor path, not a traffic-optimal
    one. The first layer runs as a plain block (conv, then BatchNorm and
    ReLU as stages); each stacked layer pads the carry by the largest
    dilation and gathers 27 shifted taps, each a read and an accumulator
    round trip, then the epilogue."""
    ab, wb = quantize.act_bytes(precision), quantize.weight_bytes(precision)
    v = math.prod(int(s) for s in vol)
    dmax = max(cfg.dilations)
    vp = math.prod(int(s) + 2 * dmax for s in vol)
    data = weights = 0
    cin = cfg.in_channels
    c = cfg.channels
    for i, _ in enumerate(cfg.dilations):
        if i == 0:
            stages = 3 if cfg.use_batchnorm else 2
            data += v * (cin + c) * ab
            data += (stages - 1) * 2 * v * c * ab
        else:
            data += v * c * ab + vp * c * ab  # pad the carry
            data += 27 * (vp + 2 * v) * c * ab  # taps, accumulator read and write
            data += 2 * v * c * ab  # epilogue
        weights += 27 * cin * c * wb
        cin = c
    data += v * (c + cfg.num_classes) * ab
    return batch * data + weights


def meshnet_megakernel_bytes(cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> int:
    """K2's (K2r's) depth-first schedule (``ops.meshnet_apply_megakernel``):
    the planner's own model, ``MegakernelPlan.hbm_bytes``, of the plan the
    forward runs for this volume, batch and policy, each role at the
    policy's width (under int8w the input and, with BatchNorm, the staging
    arrays at 1 byte). Raises ValueError when no plan fits one block's
    shared memory."""
    pln = megakernel.plan_for_config(cfg, tuple(int(s) for s in vol), precision=precision, batch=batch)
    return pln.hbm_bytes(batch)


def meshnet_collective_bytes(cfg, vol: Shape3, num_devices: int, batch: int = 1, precision: str = "fp32") -> int:
    """Modeled bytes between devices of one Z-sharded forward, the
    reference's convention for the whole family: each of the ``n - 1``
    slab boundaries exchanges, over the layer-wise schedule, ``2 *
    sum(dilations)`` Z-slices of the hidden activation, both directions
    together,

        per_boundary = 2 * sum(dilations) * H * W * C_hidden * act_bytes

    (the megakernel inner's one-shot fetch of the radius moves as many
    slices once, at the input's width; the one formula is the
    convention). Reduced policies exchange bf16 halos, so the bill halves.
    Zero on one device."""
    n = int(num_devices)
    if n <= 1:
        return 0
    _, h, w = (int(s) for s in vol)
    per_boundary = 2 * sum(cfg.dilations) * h * w * cfg.channels * quantize.act_bytes(precision)
    return batch * (n - 1) * per_boundary


def meshnet_sharded_bytes(
    inner: str, cfg, vol: Shape3, num_devices: int, batch: int = 1, precision: str = "fp32"
) -> int:
    """Modeled device-memory bytes of one Z-sharded forward: every slab
    runs the inner's schedule, so ``n`` times the inner's model at a
    slab's shape. The megakernel inner is priced at its window, the slab
    and the radius a side (what its tiles read); the layer-wise inners at
    the bare slab, their halos being ``meshnet_collective_bytes``'s.
    Raises ``ShardGeometryError`` when Z does not divide."""
    n = int(num_devices)
    d, h, w = (int(s) for s in vol)
    if d % n:
        from repro_torch.core.spatial_shard import ShardGeometryError

        raise ShardGeometryError(f"Z dim {d} not divisible by {n} slabs")
    dloc = d // n
    if inner == "cuda_megakernel":
        radius = sum(cfg.dilations)
        per_dev = meshnet_megakernel_bytes(cfg, (dloc + 2 * radius, h, w), batch=batch, precision=precision)
    else:
        per_dev = EXECUTOR_MODELS[inner](cfg, (dloc, h, w), batch=batch, precision=precision)
    return n * per_dev


#: executor name -> its modeled-bytes function, the mapping the registry
#: wires up; the views schedule (K5) serves no executor, and the sharded
#: family prices itself through ``meshnet_sharded_bytes``.
EXECUTOR_MODELS = {
    "torch": meshnet_plain_bytes,
    "cuda_fused": meshnet_fused_bytes,
    "cuda_megakernel": meshnet_megakernel_bytes,
    "streaming": meshnet_streaming_bytes,
}


def executor_hbm_bytes(name: str, cfg, vol: Shape3, batch: int = 1, precision: str = "fp32") -> Optional[int]:
    """Modeled bytes of one forward under the named executor, or None for a
    name without a model."""
    fn = EXECUTOR_MODELS.get(name)
    return None if fn is None else fn(cfg, vol, batch=batch, precision=precision)
