"""Kernel-backed MeshNet pieces: counterpart of ``repro/kernels/ops.py``.

``meshnet_apply`` is the ``cuda_fused`` backend of the executor registry
(core/executors.py): each hidden layer is ONE call of K1 (K1r at the bf16
and int8w policies) with the folded inference BatchNorm and the ReLU in
its epilogue, so an activation crosses device memory once per layer. The
kernel masks the volume's edges itself, so no padding to a block multiple
is needed.

``meshnet_apply_megakernel`` is the ``cuda_megakernel`` backend: one call
of K2 (K2r at the bf16 and int8w policies) per segment of a depth-first
plan (kernels/megakernel.py), so the hidden activations inside a segment
never reach device memory. With ``z_bounds`` it is the sharded
megakernel inner's forward on one slab window (K2z, K2r-z).

``dice`` is macro Dice from hard labels through K3, the per-class count
kernel (kernels/dice.py): one launch per call on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import dice as dice_kernel
from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import megakernel as mega_kernel
from repro_torch.kernels import quantize


dice_from_counts = dice_kernel.dice_from_counts


def dilated_conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    dilation: int = 1,
    scale=None,
    offset=None,
    fuse_affine: bool = False,
) -> torch.Tensor:
    """'Same' 3-D dilated conv for any (B, D, H, W[, Cin])."""
    if x.ndim == 4:
        x = x[..., None]
    return conv_kernel.dilated_conv3d(
        x, w, b, dilation=dilation, scale=scale, offset=offset, fuse_affine=fuse_affine
    )


def fold_batchnorm(layer: dict, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BN into (scale, offset) for the fused epilogue."""
    inv = torch.rsqrt(layer["bn_var"] + eps)
    scale = layer["bn_scale"] * inv
    offset = layer["bn_bias"] - layer["bn_mean"] * scale
    return scale, offset


def meshnet_apply(params, x: torch.Tensor, cfg, *, precision: str = "fp32") -> torch.Tensor:
    """Kernel-backed MeshNet inference forward (== meshnet.apply, eval mode).

    The epilogue is fused on every layer, so the ReLU runs even without
    BatchNorm (scale 1, offset 0). The 1x1x1 head stays a plain matrix
    product, as the reference leaves it outside its kernels.

    ``precision`` (kernels/quantize.py): at "bf16" and "int8w" the params
    are prepared (``prepare_params``, a no-op on a prepared tree), the
    input cast (``cast_input``), and every layer is one K1r launch with
    the bias, BatchNorm and (int8w) dequant scale in its fp32 epilogue
    (``fold_epilogue``); the head accumulates in fp32 and rounds its
    logits to bf16 (``quantize.head_reduced``)."""
    if x.ndim == 4:
        x = x[..., None]
    if quantize.validate(precision) != "fp32":
        params = quantize.prepare_params(params, cfg, precision)
        x = quantize.cast_input(x, precision).contiguous()
        for i, d in enumerate(cfg.dilations):
            layer = params["layers"][i]
            bias, scale, offset = quantize.fold_epilogue(layer, cfg.use_batchnorm)
            x = dilated_conv3d(
                x, layer["w"], bias, dilation=d, scale=scale, offset=offset, fuse_affine=True
            )
        return quantize.head_reduced(x, params["head"])
    x = x.contiguous()
    for i, d in enumerate(cfg.dilations):
        layer = params["layers"][i]
        if cfg.use_batchnorm:
            scale, offset = fold_batchnorm(layer)
        else:
            scale = offset = None
        x = dilated_conv3d(
            x, layer["w"], layer["b"],
            dilation=d, scale=scale, offset=offset, fuse_affine=True,
        )
    head = params["head"]
    return torch.einsum("bdhwi,io->bdhwo", x, head["w"][0, 0, 0]) + head["b"]


def meshnet_apply_megakernel(
    params,
    x: torch.Tensor,
    cfg,
    *,
    pln: Optional[mega_kernel.MegakernelPlan] = None,
    precision: str = "fp32",
    staging_scales: Optional[list] = None,
    z_bounds: Optional[tuple[int, int]] = None,
    rows: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Depth-first MeshNet forward (== meshnet.apply, eval mode): one K2
    launch per segment of ``pln`` (planned here when not given), the head
    fused into the last. The input is copied into the first staging array
    at the first segment's halo offset; every later staging array is a
    segment's output.

    ``precision`` "bf16" and "int8w" (the reference's
    ``megakernel.meshnet_apply``) launch K2r a segment on a plan made at
    the policy's widths: the params are prepared (``prepare_params``, a
    no-op on a prepared tree) and every layer's epilogue is
    ``fold_epilogue``'s. Under bf16 the input is cast to bf16. Under
    int8w the input is quantised to int8 (an int8 input is taken as
    already quantised) and stays int8 in the first staging array, its
    ``INPUT_SCALE`` folded into layer 0's epilogue scale; the staging
    between segments is int8 with ``staging_scales`` (one (C,) fp32 scale
    per hidden layer; ``quantize.staging_scales_from_bn`` when not given),
    or bf16 when the model has no BatchNorm and none are given. The
    logits are bf16.

    ``z_bounds``, a host pair of ints ``(z_lo, z_hi)``, narrows the Z-valid
    interval to its intersection with ``[0, D)``: positions outside it are
    zeroed after every layer and on the staged input, as positions outside
    the volume are (K2z and K2r-z, one launch a segment). The sharded
    executor's slab windows pass the true volume's extent here
    (core/spatial_shard.py); the plan is the window's.

    ``rows``, a host pair ``(lo, hi)``, asks only for the output rows in
    ``[lo, hi)``: segment j computes the band ``[lo - R_j, hi + R_j)``
    intersected with the valid interval, R_j the dilations of the segments
    after it (exactly the rows segment j + 1 reads), and the rows of the
    result outside ``[lo, hi)`` are left unwritten (the sharded windows
    keep only their slab's rows)."""
    if x.ndim == 4:
        x = x[..., None]
    B, D, H, W, _ = x.shape
    vol = (D, H, W)
    if quantize.validate(precision) == "fp32":
        x = x.float()
        staging_scales = None
    else:
        params = quantize.prepare_params(params, cfg, precision)
        if precision == "int8w":
            if x.dtype != torch.int8:
                x = quantize.quantize_input(x)
            if staging_scales is None:
                staging_scales = quantize.staging_scales_from_bn(params, cfg)
        else:
            x = quantize.cast_input(x, precision)
            staging_scales = None
    if pln is None:
        pln = mega_kernel.plan_for_config(
            cfg, vol, precision=precision, int8_staging=staging_scales is not None, batch=B
        )
    elif pln.vol != vol:
        raise ValueError(f"plan is for volume {pln.vol}, input is {vol}")
    elif pln.widths != mega_kernel.plan_widths(precision, staging_scales is not None):
        raise ValueError(f"plan is for widths {pln.widths}, not precision {precision!r}'s")
    first = pln.segments[0]
    h = first.halo
    if pln.widths == mega_kernel.FP32_WIDTHS or x.device.type != "cuda":
        pad = sum(((h, h + p - v) for p, v in zip(pln.padded(first)[::-1], vol[::-1])), ())
        act = F.pad(x, (0, 0) + pad)
    else:  # K2r on the card: its staging layout (megakernel.staging_empty); the border is never read
        act = mega_kernel.staging_empty((B,) + tuple(p + 2 * h for p in pln.padded(first)) + (x.shape[-1],),
                                        x.dtype, x.device)
        act[:, h : h + D, h : h + H, h : h + W] = x
    bands = mega_kernel.segment_bands(pln, rows, z_bounds) if rows is not None else [None] * len(pln.segments)
    for i, seg in enumerate(pln.segments):
        layers, head = megakernel_operands(params, cfg, seg, precision)
        deq, qscale = mega_kernel.scale_operands(pln, i)
        act = mega_kernel.run_segment(
            act, pln, i, layers, head,
            staging_scales[seg.start - 1] if deq else None,
            staging_scales[seg.start + len(seg.dilations) - 1] if qscale else None,
            z_bounds, bands[i],
        )
    return act[:, :D, :H, :W, :]


def megakernel_operands(params, cfg, seg: mega_kernel.Segment, precision: str = "fp32") -> tuple[list, Optional[tuple]]:
    """(layers, head) of one segment as ``megakernel.run_segment`` takes
    them: each layer's (w, b, scale, offset) with the BatchNorm folded
    (scale 1 and offset 0 without it), and the head's (w (C, classes), b)
    when the segment fuses it. At a reduced policy (``params`` prepared)
    each layer is ``(w, *fold_epilogue(layer))``, and under int8w layer 0's
    scale carries the input's ``INPUT_SCALE``."""
    layers = []
    for li, layer in enumerate(params["layers"][seg.start : seg.start + len(seg.dilations)]):
        if precision != "fp32":
            bias, scale, offset = quantize.fold_epilogue(layer, cfg.use_batchnorm)
            if precision == "int8w" and seg.start + li == 0:
                scale = scale * quantize.INPUT_SCALE
            layers.append((layer["w"], bias, scale, offset))
            continue
        if cfg.use_batchnorm:
            scale, offset = fold_batchnorm(layer)
        else:
            scale, offset = torch.ones_like(layer["b"]), torch.zeros_like(layer["b"])
        layers.append((layer["w"], layer["b"], scale, offset))
    head = (params["head"]["w"][0, 0, 0], params["head"]["b"]) if seg.fuse_head else None
    return layers, head


def dice(pred: torch.Tensor, truth: torch.Tensor, num_classes: int, eps: float = 1e-7) -> torch.Tensor:
    """Macro Dice score of hard labels through the count kernel (K3):
    ``dice_from_counts(dice_counts(pred, truth, num_classes))``."""
    return dice_from_counts(dice_kernel.dice_counts(pred, truth, num_classes), eps)
