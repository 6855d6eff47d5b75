"""Layer-by-layer progressive inference — counterpart of ``repro/core/streaming.py``.

Brainchop's memory strategy: at any instant one layer's weights and one
activation are live, the previous layer's tensor disposed of. The
reference stacks the shape-uniform hidden layers 2..L and runs a
``lax.scan`` whose carry is the one live activation, the conv written as
27 shifted taps (``dynamic_slice``) into a buffer padded once by the
largest dilation, so the dilation can be a scanned operand. The port runs
the same schedule as a Python loop over the stacked layers: each step pads
the carry by ``dmax`` once, accumulates the 27 taps' products in fp32, and
rebinds the carry, so the previous activation is freed and memory does
not grow with depth.

This is the ``streaming`` executor (core/executors.py), plain PyTorch by
design: the reference's is XLA, not a Pallas kernel. The reduced
policies keep the schedule: bf16 carry, bf16 or int8 stacked weights
widened to fp32 for the products, fp32 accumulation, the folded fp32
epilogue (``quantize.fold_epilogue``) and one round to bf16 a layer, the
rounding points of ``quantize.conv_block_reduced``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import meshnet
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.kernels import quantize


def stack_layer_params(params) -> tuple[dict, Optional[dict], dict]:
    """Split MeshNet params into (first_layer, stacked_middle, head): layer
    1 (Cin -> C) stays unstacked, layers 2..L are stacked leaf-wise with a
    leading layer axis (None when there are none)."""
    layers = params["layers"]
    middle = None
    if len(layers) > 1:
        middle = {k: torch.stack([layer[k] for layer in layers[1:]]) for k in layers[1]}
    return layers[0], middle, params["head"]


def _taps(carry: torch.Tensor, w3: torch.Tensor, dilation: int, dmax: int) -> torch.Tensor:
    """The 27-tap 'same' dilated conv of ``carry`` (B, D, H, W, C) by ``w3``
    (3, 3, 3, C, Cout) as the reference's scan step computes it: one pad by
    ``dmax``, each tap a shifted slice of it times its (C, Cout) matrix,
    taps in (z, y, x) order, accumulated in fp32."""
    _, D, H, W, _ = carry.shape
    xp = F.pad(carry.float(), (0, 0, dmax, dmax, dmax, dmax, dmax, dmax))
    wf = w3.float()
    acc = torch.zeros(carry.shape[:-1] + (w3.shape[-1],), dtype=torch.float32, device=carry.device)
    for tz in (-1, 0, 1):
        for ty in (-1, 0, 1):
            for tx in (-1, 0, 1):
                z, y, x = dmax + dilation * tz, dmax + dilation * ty, dmax + dilation * tx
                tap = xp[:, z : z + D, y : y + H, x : x + W, :]
                acc.add_(torch.matmul(tap, wf[tz + 1, ty + 1, tx + 1]))
    return acc


def streaming_apply(params, x: torch.Tensor, cfg: MeshNetConfig, precision: str = "fp32") -> torch.Tensor:
    """Memory-streamed forward: logits (B, D, H, W, classes), the function
    of ``meshnet.apply`` (eval mode) on the two-live-buffer schedule. At
    "bf16" and "int8w" the reduced schedule of ``_streaming_apply_reduced``."""
    if quantize.validate(precision) != "fp32":
        return _streaming_apply_reduced(params, x, cfg, precision)
    if x.ndim == 4:
        x = x[..., None]
    first, middle, head = stack_layer_params(params)
    x, _ = meshnet.apply_layer(first, x, cfg.dilations[0], cfg, training=False)
    dmax = int(max(cfg.dilations))
    for i, d in enumerate(cfg.dilations[1:]):
        layer = {k: v[i] for k, v in middle.items()}
        out = _taps(x, layer["w"], d, dmax) + layer["b"]
        if cfg.use_batchnorm:
            out = (out - layer["bn_mean"]) * torch.rsqrt(layer["bn_var"] + 1e-5)
            out = out * layer["bn_scale"] + layer["bn_bias"]
        x = torch.relu(out)
    return meshnet.dilated_conv3d(x, head["w"], head["b"], dilation=1)


def _streaming_apply_reduced(params, x: torch.Tensor, cfg: MeshNetConfig, precision: str) -> torch.Tensor:
    """The streaming schedule at bf16/int8w storage: the first layer through
    ``quantize.conv_block_reduced``, the stacked layers by hand with the
    same rounding points, the head through ``quantize.head_reduced``."""
    params = quantize.prepare_params(params, cfg, precision)
    if x.ndim == 4:
        x = x[..., None]
    x = quantize.cast_input(x, precision)
    first, middle, head = stack_layer_params(params)
    x = quantize.conv_block_reduced(x, first, cfg.dilations[0], cfg.use_batchnorm)
    dmax = int(max(cfg.dilations))
    if middle is not None:
        # fold_epilogue is elementwise over the channel axis, so it maps
        # over the stacked (L, C) leaves unchanged.
        bias, scale, offset = quantize.fold_epilogue(middle, cfg.use_batchnorm)
        for i, d in enumerate(cfg.dilations[1:]):
            acc = _taps(x, middle["w"][i], d, dmax)
            x = torch.relu((acc + bias[i]) * scale[i] + offset[i]).to(quantize.act_dtype(precision))
    return quantize.head_reduced(x, head)
