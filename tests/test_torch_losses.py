"""Port training losses (repro_torch.training.losses) against
repro.training.losses on numpy-made logits and labels. Values and the
gradient of ``segmentation_loss`` with respect to the logits agree within
1e-6 relative (float32 sums over a few thousand voxels in two orders); the
hard Dice metric, a float32 mean over the classes of terms from equal
counts, within 1e-6 (the reference's bound between its ops.dice and
dice_score, tests/test_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import losses as ref_losses
from repro_torch.training import losses

REL_TOL = 1e-6


def _seg_inputs(seed, shape=(2, 7, 8, 9), classes=3):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal(shape + (classes,))).astype(np.float32)
    labels = rng.integers(0, classes, size=shape).astype(np.int32)
    return logits, labels


def _close(got, expect, rel=REL_TOL):
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    scale = max(float(np.abs(expect).max()), 1e-30)
    assert float(np.abs(got - expect).max()) <= rel * scale, (got, expect)


@pytest.mark.parametrize("classes", [2, 3, 5])
def test_cross_entropy_and_soft_dice(classes):
    logits, labels = _seg_inputs(classes, classes=classes)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    _close(losses.cross_entropy(lt, yt), ref_losses.cross_entropy(lj, yj))
    _close(losses.soft_dice_loss(lt, yt, classes), ref_losses.soft_dice_loss(lj, yj, classes))


def test_one_hot_matches_reference_outside_the_classes_too():
    labels = np.array([[-1, 0, 1], [2, 3, 1]], np.int32)
    got = losses.one_hot(torch.from_numpy(labels), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_losses.one_hot(jnp.asarray(labels), 3)))


@pytest.mark.parametrize("dice_weight", [1.0, 0.5])
def test_segmentation_loss_and_metrics(dice_weight):
    logits, labels = _seg_inputs(11)
    loss, metrics = losses.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels), 3, dice_weight)
    ref_loss, ref_metrics = ref_losses.segmentation_loss(jnp.asarray(logits), jnp.asarray(labels), 3, dice_weight)
    _close(loss.detach(), ref_loss)
    assert set(metrics) == set(ref_metrics)
    for k in ("ce", "soft_dice_loss"):
        _close(metrics[k], ref_metrics[k])
    assert abs(float(metrics["dice"]) - float(ref_metrics["dice"])) < REL_TOL


def test_segmentation_loss_gradient_matches_jax_grad():
    logits, labels = _seg_inputs(12)
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, _ = losses.segmentation_loss(lt, torch.from_numpy(labels), 3)
    (grad,) = torch.autograd.grad(loss, lt)
    expect = jax.grad(lambda l: ref_losses.segmentation_loss(l, jnp.asarray(labels), 3)[0])(jnp.asarray(logits))
    _close(grad, expect)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss(masked):
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((2, 6, 17)).astype(np.float32)
    labels = rng.integers(0, 17, size=(2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32) if masked else None
    got = losses.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    expect = ref_losses.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    _close(got, expect)


def test_lm_loss_empty_mask_is_zero_not_nan():
    logits = torch.zeros((1, 3, 4))
    labels = torch.zeros((1, 3), dtype=torch.int64)
    assert float(losses.lm_loss(logits, labels, torch.zeros((1, 3)))) == 0.0
