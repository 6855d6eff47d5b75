"""Cropping — counterpart of ``repro/core/cropping.py``.

Run a cheap brain-mask model, crop a box of a ladder size centred on the
mask's bounding box, run the expensive model on the crop and paste the
result back. Crop sizes come from ``CROP_LADDER`` so repeated requests
see a few shapes only.
"""

from __future__ import annotations

import torch


def mask_bounding_box(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) inclusive-exclusive bounds of the True region per axis, as
    int64 tensors of shape (3,); an empty mask gives the full volume."""
    mask = mask.to(torch.bool)
    bounds_lo, bounds_hi = [], []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        line = torch.any(mask, dim=other)
        n = line.shape[0]
        idx = torch.arange(n, device=line.device)
        found = torch.any(line)
        lo = torch.where(line, idx, n).min()
        hi = torch.where(line, idx + 1, 0).max()
        bounds_lo.append(torch.where(found, lo, 0))
        bounds_hi.append(torch.where(found, hi, n))
    return torch.stack(bounds_lo), torch.stack(bounds_hi)


def crop_to(vol: torch.Tensor, mask: torch.Tensor, size: tuple[int, int, int]) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """Crop ``vol`` to a ``size`` box centred on ``mask``'s bounding box,
    clamped inside the volume. Returns (crop, start) with ``start`` the
    box's origin as ints."""
    lo, hi = mask_bounding_box(mask)
    centre = (lo + hi) // 2
    start = []
    for axis in range(3):
        s = int(centre[axis]) - size[axis] // 2
        start.append(min(max(s, 0), vol.shape[axis] - size[axis]))
    z, y, x = start
    crop = vol[z : z + size[0], y : y + size[1], x : x + size[2]]
    return crop, (z, y, x)


def uncrop(crop: torch.Tensor, start, full_shape: tuple[int, ...], fill=0) -> torch.Tensor:
    """Paste a cropped result back into a full-size volume."""
    out = torch.full(tuple(full_shape), fill, dtype=crop.dtype, device=crop.device)
    z, y, x = (int(s) for s in start)
    out[z : z + crop.shape[0], y : y + crop.shape[1], x : x + crop.shape[2]] = crop
    return out


# The ladder of crop sizes.
CROP_LADDER: tuple[tuple[int, int, int], ...] = (
    (128, 128, 128),
    (160, 160, 160),
    (192, 192, 192),
    (224, 224, 224),
    (256, 256, 256),
)


def pick_crop_size(mask: torch.Tensor, ladder=CROP_LADDER, margin: int = 4) -> tuple[int, int, int]:
    """Smallest ladder entry (capped at the volume) that holds the mask's
    bounding box plus ``margin`` on each side."""
    lo, hi = mask_bounding_box(mask)
    extent = [int(e) + 2 * margin for e in (hi - lo).tolist()]
    vol_shape = tuple(mask.shape)
    for size in ladder:
        size = tuple(min(s, v) for s, v in zip(size, vol_shape))
        if all(e <= s for e, s in zip(extent, size)):
            return size
    return tuple(min(s, v) for s, v in zip(ladder[-1], vol_shape))
