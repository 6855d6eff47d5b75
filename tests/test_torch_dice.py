"""K3's CPU path (the plain per-class counts) and ``ops.dice`` against the
reference: ``repro.kernels.ref.dice_counts``, ``repro.training.losses.
dice_score``, ``repro.kernels.ops.dice`` and, in one small case, the Pallas
``dice_counts`` in interpret mode. Counts are integers: they must be
equal. The scores are float32 means over the classes of equal per-class
terms; the two frameworks sum the C terms in their own order, so against
the reference they agree within 1e-6, the bound the reference holds its
own ``ops.dice`` and ``dice_score`` to (``tests/test_kernels.py``), and
within the port ``ops.dice`` equals ``dice_from_counts`` of the plain
counts exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dice as ref_dice_kernel
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.training import losses as ref_losses
from repro_torch.kernels import dice as dice_kernel
from repro_torch.kernels import ops, ref

SCORE_TOL = 1e-6  # tests/test_kernels.py::TestDiceKernel::test_dice_score_matches_losses

def _labels(seed, shape, classes, dtype, *, absent=None, outside=True):
    """Labels in [0, C) made with numpy; with ``outside`` some are -1, C and
    2^30, which count nowhere; class ``absent`` never occurs."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, classes, size=shape)
    if absent is not None:
        lab[lab == absent] = (absent + 1) % classes
    if outside:
        flat = lab.reshape(-1)
        picks = rng.choice(flat.size, size=3 * max(1, flat.size // 50), replace=False)
        flat[picks] = np.resize([-1, classes, 2**30], picks.size)
    return lab.astype(dtype)


CASES = [
    # (shape, classes, pred dtype, truth dtype)
    ((31, 33, 17), 2, np.int32, np.int32),
    ((31, 33, 17), 3, np.int64, np.int32),
    ((2, 9, 10, 11), 3, np.int64, np.int64),
    ((2, 9, 10, 11), 50, np.int32, np.int64),
    ((5, 7, 11), 104, np.int64, np.int32),
]


@pytest.mark.parametrize("shape,classes,pdt,tdt", CASES)
def test_counts_equal_reference_oracle(shape, classes, pdt, tdt):
    pred = _labels(1, shape, classes, pdt, absent=classes - 1)
    truth = _labels(2, shape, classes, tdt, absent=classes - 1)
    got = dice_kernel.dice_counts(torch.from_numpy(pred), torch.from_numpy(truth), classes)
    assert got.dtype == torch.int32 and tuple(got.shape) == (classes, 3)
    expect = np.asarray(ref_kernels.dice_counts(jnp.asarray(pred), jnp.asarray(truth), classes))
    np.testing.assert_array_equal(got.numpy(), expect)
    assert got[classes - 1].tolist() == [0, 0, 0]  # the absent class


@pytest.mark.parametrize("shape,classes,pdt,tdt", CASES)
def test_dice_equals_reference_dice_score_and_ops_dice(shape, classes, pdt, tdt):
    pred = _labels(3, shape, classes, pdt, absent=0, outside=False)
    truth = _labels(4, shape, classes, tdt, absent=0, outside=False)
    got = float(ops.dice(torch.from_numpy(pred), torch.from_numpy(truth), classes))
    p, t = jnp.asarray(pred), jnp.asarray(truth)
    assert abs(got - float(ref_losses.dice_score(p, t, classes))) < SCORE_TOL
    assert abs(got - float(ref_ops.dice(p, t, classes, interpret=True))) < SCORE_TOL
    counts = ref.dice_counts(torch.from_numpy(pred), torch.from_numpy(truth), classes)
    assert got == float(ops.dice_from_counts(counts))


def test_counts_equal_pallas_kernel_in_interpret_mode():
    """One small case against the TPU kernel itself (block 64, so the
    volume's 17391 labels are padded with -1/-2 to a block multiple)."""
    pred = _labels(5, (31, 33, 17), 3, np.int32, outside=False)
    truth = _labels(6, (31, 33, 17), 3, np.int32, outside=False)
    expect = np.asarray(ref_dice_kernel.dice_counts(jnp.asarray(pred), jnp.asarray(truth), 3,
                                                    block=64, interpret=True))
    got = dice_kernel.dice_counts(torch.from_numpy(pred), torch.from_numpy(truth), 3)
    np.testing.assert_array_equal(got.numpy(), expect)


def test_out_of_range_labels_count_nowhere():
    pred = torch.tensor([-2, -1, 0, 1, 2, 3, 2**30, 1], dtype=torch.int64)
    truth = torch.tensor([-2, -1, 0, 1, 5, 3, 2**30, 0], dtype=torch.int32)
    counts = dice_kernel.dice_counts(pred, truth, 3)
    assert counts.tolist() == [[1, 1, 2], [1, 2, 1], [0, 1, 0]]


def test_empty_classes_score_one():
    x = torch.zeros((4, 4, 4), dtype=torch.int32)
    assert float(ops.dice(x, x, 5)) == 1.0
    counts = dice_kernel.dice_counts(x, x, 5)
    assert counts[1:].sum() == 0 and counts[0].tolist() == [64, 64, 64]


def test_wrapper_rejects_what_no_path_takes():
    a = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        dice_kernel.dice_counts(a, a.reshape(4, 3), 2)
    with pytest.raises(ValueError, match="num_classes"):
        dice_kernel.dice_counts(a, a, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        big = torch.zeros(1, dtype=torch.int32).expand(2**31)
        dice_kernel.dice_counts(big, big, 2)
    before = dice_kernel.launches
    dice_kernel.dice_counts(a, a, 2)
    assert dice_kernel.launches == before  # the CPU path is no launch
