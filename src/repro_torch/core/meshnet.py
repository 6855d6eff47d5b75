"""MeshNet in PyTorch — counterpart of ``repro/core/meshnet.py``.

A feed-forward 3-D CNN of 3x3x3 dilated convolutions (dilation schedule
1,2,4,8,16,8,4,2,1), each followed by BatchNorm and ReLU, and a 1x1x1
classifier head. Volumes are channels-last ``(B, D, H, W, C)``; params
are the reference's tree, ``{"layers": [dict, ...], "head": dict}`` with
DHWIO conv weights, so weights cross between the packages unchanged
(``repro_torch.bridge``). ``MeshNet`` is the ``nn.Module`` over such a
tree.

Inference only in this slice: training-mode BatchNorm statistics,
dropout and ``apply_with_stats`` come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels import ref

Params = Any


@dataclasses.dataclass(frozen=True)
class MeshNetConfig:
    """Hyperparameters for a MeshNet model (the reference's fields, less
    its array dtype: the port runs fp32)."""

    in_channels: int = 1
    channels: int = 5
    num_classes: int = 3
    dilations: Sequence[int] = (1, 2, 4, 8, 16, 8, 4, 2, 1)

    def __post_init__(self):
        object.__setattr__(self, "dilations", tuple(self.dilations))

    kernel_size: int = 3
    dropout_rate: float = 0.0
    use_batchnorm: bool = True

    @property
    def num_layers(self) -> int:
        return len(self.dilations) + 1

    def param_count(self) -> int:
        """Conv parameters only (the paper's convention, BN excluded)."""
        k = self.kernel_size ** 3
        n = self.in_channels * self.channels * k + self.channels
        for _ in self.dilations[1:]:
            n += self.channels * self.channels * k + self.channels
        n += self.channels * self.num_classes + self.num_classes
        return n


PAPER_MODELS = {
    "gwm_light": MeshNetConfig(channels=5, num_classes=3),
    "gwm_large": MeshNetConfig(channels=10, num_classes=3),
    "brain_mask_fast": MeshNetConfig(channels=5, num_classes=2),
    "brain_mask_high_acc": MeshNetConfig(channels=10, num_classes=2),
    "extract_brain_fast": MeshNetConfig(channels=5, num_classes=2),
    "subvolume_gwm_failsafe": MeshNetConfig(channels=21, num_classes=3),
    "atlas_50": MeshNetConfig(channels=10, num_classes=50),
    "atlas_104": MeshNetConfig(channels=18, num_classes=104),
}


def _conv_init(gen: torch.Generator, kshape, device) -> torch.Tensor:
    fan_in = int(np.prod(kshape[:-1]))
    std = float(np.sqrt(2.0 / fan_in))  # He init for ReLU nets
    return (torch.randn(kshape, generator=gen) * std).to(device)


def init(
    cfg: MeshNetConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """MeshNet params on ``device``: He-initialised conv weights, zero
    biases, identity BN. Numbers are drawn on the CPU from ``generator``
    (they differ from the reference's for the same seed)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    k = cfg.kernel_size
    layers = []
    in_ch = cfg.in_channels
    for _ in cfg.dilations:
        layer = {
            "w": _conv_init(gen, (k, k, k, in_ch, cfg.channels), dev),
            "b": torch.zeros(cfg.channels, device=dev),
        }
        if cfg.use_batchnorm:
            layer["bn_scale"] = torch.ones(cfg.channels, device=dev)
            layer["bn_bias"] = torch.zeros(cfg.channels, device=dev)
            layer["bn_mean"] = torch.zeros(cfg.channels, device=dev)
            layer["bn_var"] = torch.ones(cfg.channels, device=dev)
        layers.append(layer)
        in_ch = cfg.channels
    head = {
        "w": _conv_init(gen, (1, 1, 1, cfg.channels, cfg.num_classes), dev),
        "b": torch.zeros(cfg.num_classes, device=dev),
    }
    return {"layers": layers, "head": head}


def dilated_conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int) -> torch.Tensor:
    """'Same'-padded 3-D dilated convolution, channels-last, + bias."""
    return ref.dilated_conv3d(x, w, b, dilation=dilation)


def batchnorm(x: torch.Tensor, layer: dict, *, eps: float = 1e-5) -> torch.Tensor:
    """Inference BatchNorm3d with the layer's running statistics."""
    return (x - layer["bn_mean"]) * torch.rsqrt(layer["bn_var"] + eps) * layer["bn_scale"] + layer["bn_bias"]


def apply_layer(layer: dict, x: torch.Tensor, dilation: int, cfg: MeshNetConfig) -> torch.Tensor:
    """One MeshNet block in eval mode: conv -> BN -> ReLU."""
    x = dilated_conv3d(x, layer["w"], layer["b"], dilation)
    if cfg.use_batchnorm:
        x = batchnorm(x, layer)
    return torch.relu(x)


def apply(params: Params, x: torch.Tensor, cfg: MeshNetConfig) -> torch.Tensor:
    """Eval forward -> logits (B, D, H, W, num_classes). Each layer's
    activation is freed when the loop rebinds ``x``, so the memory held
    does not grow with depth."""
    if x.ndim == 4:
        x = x[..., None]
    for i, dilation in enumerate(cfg.dilations):
        x = apply_layer(params["layers"][i], x, dilation, cfg)
    head = params["head"]
    return dilated_conv3d(x, head["w"], head["b"], dilation=1)


def predict(params: Params, x: torch.Tensor, cfg: MeshNetConfig) -> torch.Tensor:
    """Hard segmentation labels (B, D, H, W) int32."""
    return torch.argmax(apply(params, x, cfg), dim=-1).to(torch.int32)


class MeshNet(nn.Module):
    """``nn.Module`` over a params tree: the tensors become parameters
    (weights, biases, BN affine) and buffers (BN running statistics), and
    ``forward`` is ``apply``."""

    _BUFFERS = ("bn_mean", "bn_var")

    def __init__(self, cfg: MeshNetConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(self._block(layer) for layer in params["layers"])
        self.head = self._block(params["head"])

    def _block(self, tensors: dict) -> nn.Module:
        block = nn.Module()
        for name, t in tensors.items():
            if name in self._BUFFERS:
                block.register_buffer(name, t)
            else:
                block.register_parameter(name, nn.Parameter(t, requires_grad=False))
        return block

    def params(self) -> Params:
        """The module's tensors as a params tree (shared storage)."""

        def tree(block):
            return {**dict(block.named_parameters()), **dict(block.named_buffers())}

        return {"layers": [tree(b) for b in self.layers], "head": tree(self.head)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self.params(), x, self.cfg)
