"""Kernel-backed MeshNet pieces: counterpart of ``repro/kernels/ops.py``.

``meshnet_apply`` is the ``cuda_fused`` backend of the executor registry
(core/executors.py): each hidden layer is ONE call of K1 with the folded
inference BatchNorm and the ReLU in its epilogue, so an activation crosses
device memory once per layer. The kernel masks the volume's edges itself,
so no padding to a block multiple is needed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import quantize


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
    product, as the reference leaves it outside its kernels."""
    quantize.validate(precision)
    if x.ndim == 4:
        x = x[..., None]
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
