"""3-D connected components — counterpart of ``repro/core/components.py``.

Label propagation: seed every foreground voxel with its int32 linear
index, then repeat ``label = min over the 6-neighbourhood`` followed by a
pointer jump (each voxel takes its current root's label) until nothing
changes. Each component ends labelled by the minimum linear index of its
voxels, so labels are deterministic and equal the reference's bit for bit.
"""

from __future__ import annotations

import torch

_BIG = torch.iinfo(torch.int32).max


def _neighbor_min(labels: torch.Tensor) -> torch.Tensor:
    """Min over the 6-neighbourhood (face adjacency), edge-clamped."""
    out = labels
    for axis in range(3):
        n = labels.shape[axis]
        fwd = torch.cat([labels.narrow(axis, 1, n - 1), labels.narrow(axis, n - 1, 1)], dim=axis)
        bwd = torch.cat([labels.narrow(axis, 0, 1), labels.narrow(axis, 0, n - 1)], dim=axis)
        out = torch.minimum(out, torch.minimum(fwd, bwd))
    return out


def connected_components(mask: torch.Tensor) -> torch.Tensor:
    """Label connected components of a boolean (D, H, W) mask: int32
    labels, background -1, each component labelled by the minimum linear
    index of its voxels."""
    mask = mask.to(torch.bool)
    n = mask.numel()
    big = torch.full((), _BIG, dtype=torch.int32, device=mask.device)
    seed = torch.arange(n, dtype=torch.int32, device=mask.device).reshape(mask.shape)
    labels = torch.where(mask, seed, big)
    while True:
        new = torch.where(mask, _neighbor_min(labels), big)
        flat = new.reshape(-1)
        jumped = flat[torch.clamp(flat, 0, n - 1).long()].reshape(mask.shape)
        new = torch.minimum(new, torch.where(mask, jumped, big))
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(mask, labels, torch.full((), -1, dtype=torch.int32, device=mask.device))


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Voxel count per label id (flat, length = labels.numel(); sparse)."""
    flat = labels.reshape(-1)
    valid = flat >= 0
    sizes = torch.zeros(flat.numel(), dtype=torch.int32, device=labels.device)
    return sizes.index_add_(0, torch.where(valid, flat, 0).long(), valid.to(torch.int32))


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Keep only the largest connected component of a boolean mask (the
    first one by label on a tie)."""
    labels = connected_components(mask)
    best = torch.argmax(component_sizes(labels))
    return labels == best


def remove_small_components(mask: torch.Tensor, min_size: int) -> torch.Tensor:
    """Drop components with fewer than ``min_size`` voxels (noise filter)."""
    labels = connected_components(mask)
    keep = component_sizes(labels) >= min_size
    return torch.where(labels >= 0, keep[torch.clamp(labels, min=0).long()], False)


def filter_segmentation(seg: torch.Tensor, num_classes: int, min_size: int = 64) -> torch.Tensor:
    """Per-class noise filtering of a hard segmentation (D, H, W): for each
    non-background class, connected regions smaller than ``min_size``
    become background 0."""
    out = seg
    for c in range(1, num_classes):
        mask = seg == c
        kept = remove_small_components(mask, min_size)
        out = torch.where(mask & ~kept, torch.zeros((), dtype=seg.dtype, device=seg.device), out)
    return out
