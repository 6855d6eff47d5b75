"""Training losses and metrics — counterpart of ``repro/training/losses.py``.

The paper trains MeshNet with cross-entropy and tracks macro Dice from
hard labels (its eq. 2); the trainer minimises CE + soft Dice. Logits are
channels-last ``(..., C)`` as everywhere in the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    """(..., C) indicator of ``labels``; a label outside [0, C) is all
    zeros, as ``jax.nn.one_hot`` gives."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all voxels/tokens. logits (..., C), labels (...) int."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())
    return -torch.mean(ll)


def dice_score(pred: torch.Tensor, truth: torch.Tensor, num_classes: int, eps: float = 1e-7) -> torch.Tensor:
    """Macro Dice over classes from *hard* labels (eq. 2 of the paper):
    DICE_c = 2|X_c ∩ Y_c| / (|X_c| + |Y_c|); a class absent from both pred
    and truth scores 1.

    This is both the reference's ``losses.dice_score`` and its ``ops.dice``
    (the same function), computed as the latter: ``ops.dice``, the counts
    from K3 on the card."""
    return ops.dice(pred, truth, num_classes, eps)


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int, eps: float = 1e-7) -> torch.Tensor:
    """Differentiable (soft) macro Dice loss: 1 - mean_c dice(p_c, y_c)."""
    probs = torch.softmax(logits, dim=-1)
    y = one_hot(labels, num_classes, probs.dtype)
    dims = tuple(range(probs.ndim - 1))
    inter = torch.sum(probs * y, dim=dims)
    denom = torch.sum(probs, dim=dims) + torch.sum(y, dim=dims)
    dice = (2.0 * inter + eps) / (denom + eps)
    return 1.0 - torch.mean(dice)


def segmentation_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    dice_weight: float = 1.0,
) -> tuple[torch.Tensor, dict]:
    """CE + dice_weight * soft Dice -> (loss, metrics). The metrics are
    detached scalars: ``ce``, ``soft_dice_loss`` and the hard ``dice`` of
    the logits' argmax (one K3 launch on the card)."""
    ce = cross_entropy(logits, labels)
    sd = soft_dice_loss(logits, labels, num_classes)
    loss = ce + dice_weight * sd
    hard = torch.argmax(logits.detach(), dim=-1)
    return loss, {
        "ce": ce.detach(),
        "soft_dice_loss": sd.detach(),
        "dice": dice_score(hard, labels, num_classes),
    }


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-level CE: logits (B, T, V), labels (B, T); ``mask`` optional
    (B, T) weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
