"""Plain PyTorch versions of the port's kernels.

Each is the CPU path of its kernel's wrapper and, on the card, the version
``chip_smoke.py`` holds the kernel against. They repeat the kernel's
arithmetic in plain tensor code and are no yardstick of speed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dilated_conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    dilation: int = 1,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    fuse_affine: bool = False,
) -> torch.Tensor:
    """'Same'-padded k^3 dilated conv, channels-last, + bias (+ affine+ReLU).

    x: (B, D, H, W, Cin); w: (k, k, k, Cin, Cout); b: (Cout,). Computed as
    the sum over the k^3 taps of a shifted slice of the zero-padded input
    times that tap's (Cin, Cout) matrix, taps in (z, y, x) order with x
    fastest, accumulated in fp32. Output voxel p reads input p + t*d
    (correlation, as the reference's XLA conv). With ``fuse_affine``:
    ``relu((conv + b) * scale + offset)``, scale 1 and offset 0 when absent.
    """
    k = w.shape[0]
    pad = dilation * (k - 1) // 2
    _, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, pad, pad, pad, pad, pad, pad))
    wf = w.float()
    out = None
    for tz in range(k):
        for ty in range(k):
            for tx in range(k):
                sl = xp[
                    :,
                    tz * dilation : tz * dilation + d,
                    ty * dilation : ty * dilation + h,
                    tx * dilation : tx * dilation + wd,
                    :,
                ]
                term = torch.matmul(sl, wf[tz, ty, tx])
                out = term if out is None else out.add_(term)
    out = out + b.float()
    if fuse_affine:
        if scale is not None:
            out = out * scale.float()
        if offset is not None:
            out = out + offset.float()
        out = torch.relu(out)
    return out.to(x.dtype)
