"""MeshNet in PyTorch — counterpart of ``repro/core/meshnet.py``.

A feed-forward 3-D CNN of 3x3x3 dilated convolutions (dilation schedule
1,2,4,8,16,8,4,2,1), each followed by BatchNorm and ReLU, and a 1x1x1
classifier head. Volumes are channels-last ``(B, D, H, W, C)``; params
are the reference's tree, ``{"layers": [dict, ...], "head": dict}`` with
DHWIO conv weights, so weights cross between the packages unchanged
(``repro_torch.bridge``). ``MeshNet`` is the ``nn.Module`` over such a
tree.

The eval forward (``apply``, ``predict``) computes each conv with the
plain version of K1 (``kernels/ref.py``), which the executors' kernel
paths are held to. The training forward (``apply(training=True)``,
``apply_with_stats``) normalises with the batch's statistics, drops whole
channels (Dropout3d) and computes each conv with ``F.conv3d`` on a
channels-first view of the channels-last data, under autograd. That is
the library counterpart of the reference's XLA convolution, chosen for
memory: the plain conv's 27 shifted slices would each be kept for the
backward, 27 copies of the input per layer. TF32 is off for it
(``fp32_convs``), as the reference computes in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
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


@contextlib.contextmanager
def fp32_convs():
    """Within the block, cuDNN convolutions compute in full fp32: TF32,
    PyTorch's default for them, is off (restored on exit). A backward that
    should match must run inside the block too."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def conv3d_train(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dilation: int) -> torch.Tensor:
    """'Same'-padded 3-D dilated convolution + bias for the training
    forward: ``F.conv3d`` on the channels-first view of ``x`` (B, D, H, W,
    Cin) and of the DHWIO ``w``, differentiable, channels-last out."""
    k = w.shape[0]
    pad = dilation * (k - 1) // 2
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, padding=pad, dilation=dilation)
    return out.permute(0, 2, 3, 4, 1)


def batchnorm(
    x: torch.Tensor, layer: dict, *, training: bool = False, eps: float = 1e-5
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm3d over (B, D, H, W) -> (y, mean, var). Training: the
    batch's mean and biased variance (the reference's ``jnp.var``); eval:
    the layer's running statistics."""
    if training:
        mean = x.mean(dim=(0, 1, 2, 3))
        var = x.var(dim=(0, 1, 2, 3), unbiased=False)
    else:
        mean, var = layer["bn_mean"], layer["bn_var"]
    y = (x - mean) * torch.rsqrt(var + eps) * layer["bn_scale"] + layer["bn_bias"]
    return y, mean, var


def dropout3d(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Drop whole channels per sample with probability ``rate`` and scale
    the kept ones by 1/keep; the (B, 1, 1, 1, C) mask is drawn from
    ``generator`` on its device."""
    keep = 1.0 - rate
    shape = (x.shape[0], 1, 1, 1, x.shape[-1])
    mask = (torch.rand(shape, generator=generator, device=generator.device) < keep).to(x.device, x.dtype)
    return x * mask / keep


def apply_layer(
    layer: dict,
    x: torch.Tensor,
    dilation: int,
    cfg: MeshNetConfig,
    *,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, Optional[tuple[torch.Tensor, torch.Tensor]]]:
    """One MeshNet block: conv -> BN -> ReLU (-> Dropout3d when training
    with a generator and a dropout rate) -> (x, (mean, var) or None)."""
    conv = conv3d_train if training else dilated_conv3d
    x = conv(x, layer["w"], layer["b"], dilation)
    stats = None
    if cfg.use_batchnorm:
        x, mean, var = batchnorm(x, layer, training=training)
        stats = (mean, var)
    x = torch.relu(x)
    if training and cfg.dropout_rate > 0.0 and generator is not None:
        x = dropout3d(x, cfg.dropout_rate, generator)
    return x, stats


def apply(
    params: Params,
    x: torch.Tensor,
    cfg: MeshNetConfig,
    *,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Forward -> logits (B, D, H, W, num_classes); eval mode unless
    ``training`` (then as ``apply_with_stats``, statistics dropped). Each
    layer's activation is freed when the loop rebinds ``x``, so in eval
    mode the memory held does not grow with depth."""
    if training:
        return apply_with_stats(params, x, cfg, generator=generator)[0]
    if x.ndim == 4:
        x = x[..., None]
    for i, dilation in enumerate(cfg.dilations):
        x, _ = apply_layer(params["layers"][i], x, dilation, cfg)
    head = params["head"]
    return dilated_conv3d(x, head["w"], head["b"], dilation=1)


def apply_with_stats(
    params: Params,
    x: torch.Tensor,
    cfg: MeshNetConfig,
    *,
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, list]:
    """Training forward -> (logits, stats): BatchNorm on the batch's
    statistics, Dropout3d from ``generator`` when the config has a rate,
    and per layer the batch's (mean, var), or None without BatchNorm, for
    the trainer to fold into the running estimates."""
    if x.ndim == 4:
        x = x[..., None]
    stats = []
    with fp32_convs():
        for i, dilation in enumerate(cfg.dilations):
            x, st = apply_layer(params["layers"][i], x, dilation, cfg, training=True, generator=generator)
            stats.append(st)
        head = params["head"]
        return conv3d_train(x, head["w"], head["b"], dilation=1), stats


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
