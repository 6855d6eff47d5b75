"""3-D U-Net baseline (the paper's Table II comparison model) —
counterpart of ``repro/core/unet3d.py``.

A volumetric U-Net of ``levels`` encoder stages (two 3x3x3 conv + ReLU,
then a 2x2x2 max-pool), a bottleneck of twice the deepest width, and a
decoder of 2x2x2 stride-2 up-convolutions, each followed by a skip
concatenation and two more convs; a 1x1x1 head gives the logits.
Volumes are channels-last ``(B, D, H, W[, C])`` and conv weights DHWIO,
as in ``core/meshnet.py``; the params tree is the reference's
(``{"enc": [...], "bottleneck": {...}, "dec": [...], "head": {...}}``),
so weights cross between the packages unchanged
(``bridge.unet3d_from_numpy``).

The reference computes its convolutions with XLA (``lax.conv_general_
dilated``, ``reduce_window`` and ``conv_transpose``), outside any Pallas
kernel, so the port uses the library's: ``F.conv3d``, ``F.max_pool3d``
and ``F.conv_transpose3d``, in fp32 with TF32 off (``meshnet.fp32_convs``).
The reference's up-conv is ``lax.conv_transpose(..., (2, 2, 2), "SAME")``
with ``transpose_kernel=False``: a correlation of the stride-dilated
input, so output voxel ``2m + j`` takes kernel tap ``1 - j``, where
``F.conv_transpose3d`` (the gradient of a correlation) takes tap ``j``.
``_upconv`` therefore flips the kernel in D, H and W.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.meshnet import fp32_convs

Params = Any


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """The reference's fields, less its array dtype (the port runs fp32)."""

    in_channels: int = 1
    num_classes: int = 3
    base_channels: int = 16
    levels: int = 3

    def channel_plan(self) -> Sequence[int]:
        return [self.base_channels * (2 ** i) for i in range(self.levels)]

    def param_count(self) -> int:
        """Every parameter of the tree (weights and biases)."""
        return sum(int(np.prod(s)) for s in leaf_shapes(self).values())


def _double_conv_shapes(cin: int, cout: int) -> dict:
    return {"w1": (3, 3, 3, cin, cout), "b1": (cout,), "w2": (3, 3, 3, cout, cout), "b2": (cout,)}


def param_shapes(cfg: UNet3DConfig) -> dict:
    """The params tree with each leaf's shape in its place."""
    plan = cfg.channel_plan()
    enc, dec = [], []
    cin = cfg.in_channels
    for ch in plan:
        enc.append(_double_conv_shapes(cin, ch))
        cin = ch
    bott_ch = plan[-1] * 2
    cin = bott_ch
    for ch in reversed(plan):
        dec.append({"up_w": (2, 2, 2, cin, ch), "up_b": (ch,), "conv": _double_conv_shapes(ch * 2, ch)})
        cin = ch
    return {
        "enc": enc,
        "bottleneck": _double_conv_shapes(plan[-1], bott_ch),
        "dec": dec,
        "head": {"w": (1, 1, 1, plan[0], cfg.num_classes), "b": (cfg.num_classes,)},
    }


def leaf_shapes(cfg: UNet3DConfig) -> dict:
    """``{path: shape}`` of every leaf, paths as ``tree.leaves_with_paths``
    gives them (dict keys, list indices)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        else:
            out[path] = node

    walk(param_shapes(cfg), ())
    return out


def init(cfg: UNet3DConfig, *, generator: Optional[torch.Generator] = None, device=None) -> Params:
    """U-Net params on ``device``: He-initialised weights (fan-in over all
    but the output axis), zero biases. Numbers are drawn on the CPU from
    ``generator``, in the reference's tree order (they differ from the
    reference's for the same seed)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def leaf(name, shape):
        if name.startswith("b") or name == "up_b":
            return torch.zeros(shape, device=dev)
        std = float(np.sqrt(2.0 / int(np.prod(shape[:-1]))))
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def build(node, name=""):
        if isinstance(node, dict):
            return {k: build(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return leaf(name, node)

    return build(param_shapes(cfg))


def _conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """'Same'-padded 3x3x3 conv + bias on channels-first ``x``; ``w`` DHWIO."""
    return F.conv3d(x, w.permute(4, 3, 0, 1, 2), b, padding=1)


def _double_conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(_conv3(x, p["w1"], p["b1"]))
    return torch.relu(_conv3(x, p["w2"], p["b2"]))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(x, kernel_size=2, stride=2)


def _upconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's stride-2 2x2x2 ``conv_transpose`` on channels-first
    ``x``: ``F.conv_transpose3d`` with the DHWIO kernel flipped in D, H
    and W and laid out (I, O, kD, kH, kW)."""
    return F.conv_transpose3d(x, w.flip(0, 1, 2).permute(3, 4, 0, 1, 2), b, stride=2)


def apply(params: Params, x: torch.Tensor, cfg: UNet3DConfig) -> torch.Tensor:
    """Forward -> logits (B, D, H, W, num_classes). D, H and W must be
    multiples of 2^levels."""
    if x.ndim == 4:
        x = x[..., None]
    step = 2 ** cfg.levels
    if any(s % step for s in x.shape[1:4]):
        raise ValueError(f"U-Net input {tuple(x.shape[1:4])} is not a multiple of 2^levels = {step}")
    x = x.permute(0, 4, 1, 2, 3)  # channels-first view of the channels-last data
    skips = []
    with fp32_convs():
        for p in params["enc"]:
            x = _double_conv(p, x)
            skips.append(x)
            x = _maxpool(x)
        x = _double_conv(params["bottleneck"], x)
        for p, skip in zip(params["dec"], reversed(skips)):
            x = _upconv(x, p["up_w"], p["up_b"])
            x = torch.cat([x, skip], dim=1)
            x = _double_conv(p["conv"], x)
    head = params["head"]
    # 1x1x1 head: a pointwise projection over channels, channels-last out
    return x.permute(0, 2, 3, 4, 1) @ head["w"][0, 0, 0] + head["b"]


def predict(params: Params, x: torch.Tensor, cfg: UNet3DConfig) -> torch.Tensor:
    """Hard labels (B, D, H, W) int32."""
    return torch.argmax(apply(params, x, cfg), dim=-1).to(torch.int32)
