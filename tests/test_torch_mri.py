"""Port synthetic MRI (repro_torch.data.mri.generate) against
repro.data.mri.generate. The two draw different random numbers, so they
are held by label fractions and intensity ranges, not by bits."""

import jax
import numpy as np
import torch

from repro.data import mri as ref_mri
from repro_torch.data import mri

SHAPE = (32, 32, 32)
SEEDS = range(4)


def _fractions(labels):
    labels = np.asarray(labels)
    return np.array([(labels == c).mean() for c in range(3)])


def test_label_fractions_match_reference():
    ref_gen = jax.jit(lambda key: ref_mri.generate(key, ref_mri.SyntheticMRIConfig(shape=SHAPE)))
    ref = np.mean([_fractions(ref_gen(jax.random.PRNGKey(s))[1]) for s in SEEDS], axis=0)
    ours = []
    for s in SEEDS:
        vol, labels = mri.generate(
            torch.Generator().manual_seed(s), mri.SyntheticMRIConfig(shape=SHAPE), device="cpu"
        )
        assert vol.shape == labels.shape == SHAPE
        assert vol.dtype == torch.float32 and labels.dtype == torch.int32
        assert float(vol.min()) >= 0.0 and float(vol.max()) <= 1.0
        ours.append(_fractions(labels.numpy()))
    ours = np.mean(ours, axis=0)
    # background, gray matter, white matter: each within 3 points
    np.testing.assert_allclose(ours, ref, atol=0.03)
    assert ours[1] > 0.02 and ours[2] > 0.02  # both tissues present


def test_same_seed_same_volume():
    cfg = mri.SyntheticMRIConfig(shape=(12, 14, 10))
    a = mri.generate(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = mri.generate(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
