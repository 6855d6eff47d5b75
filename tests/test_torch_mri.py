"""Port synthetic MRI (repro_torch.data.mri.generate, DataLoader) against
repro.data.mri. The two draw different random numbers, so volumes are
held by label fractions and intensity ranges, not by bits; batches by
shapes, dtypes, sub-cube cuts and one-hot labels."""

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


def test_dataloader_batches_match_reference_shapes_and_dtypes():
    shape = (12, 14, 10)
    for subvolumes, one_hot in ((False, False), (True, False), (True, True)):
        kw = dict(mri=None, batch_size=3, subvolumes=subvolumes, cube=8, num_classes=3, one_hot=one_hot, seed=2)
        ref_vol, ref_lab = next(iter(ref_mri.DataLoader(ref_mri.DataLoaderConfig(
            **dict(kw, mri=ref_mri.SyntheticMRIConfig(shape=shape))))))
        loader = mri.DataLoader(mri.DataLoaderConfig(**dict(kw, mri=mri.SyntheticMRIConfig(shape=shape))), device="cpu")
        vol, lab = next(iter(loader))
        assert tuple(vol.shape) == ref_vol.shape and tuple(lab.shape) == ref_lab.shape
        assert str(vol.dtype).split(".")[-1] == str(ref_vol.dtype)
        assert str(lab.dtype).split(".")[-1] == str(ref_lab.dtype)


def test_dataloader_stream_is_fixed_by_its_seed():
    cfg = mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(10, 10, 10)), batch_size=2, seed=5)
    a, b = iter(mri.DataLoader(cfg, device="cpu")), iter(mri.DataLoader(cfg, device="cpu"))
    first, second = next(a), next(a)
    assert all(torch.equal(x, y) for x, y in zip(first, next(b)))
    assert not torch.equal(first[0], second[0])
    assert not torch.equal(first[0][0], first[0][1])  # each batch member its own subject


def test_subvolumes_are_aligned_cuts_of_the_batch():
    """A sub-cube's volume and labels are the same c^3 window of one sample."""
    shape = (16, 16, 16)
    full = mri.DataLoader(mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=shape), batch_size=2, seed=4),
                          device="cpu")
    cut = mri.DataLoader(mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=shape), batch_size=2, seed=4,
                                              subvolumes=True, cube=6), device="cpu")
    (vol, lab), (sv, sl) = next(iter(full)), next(iter(cut))
    assert tuple(sv.shape) == tuple(sl.shape) == (2, 6, 6, 6)
    for i in range(2):
        hits = [
            (z, y, x)
            for z in range(11) for y in range(11) for x in range(11)
            if torch.equal(vol[i, z:z + 6, y:y + 6, x:x + 6], sv[i])
        ]
        assert hits, "the sub-cube is a window of its sample"
        z, y, x = hits[0]
        assert torch.equal(lab[i, z:z + 6, y:y + 6, x:x + 6], sl[i])


def test_one_hot_labels_match_reference_one_hot():
    """With ``one_hot`` the loader's labels are jax.nn.one_hot of the
    labels it streams without it (the same seed, the same subjects)."""
    kw = dict(mri=mri.SyntheticMRIConfig(shape=(8, 9, 10)), batch_size=2, num_classes=3, seed=6)
    _, lab = next(iter(mri.DataLoader(mri.DataLoaderConfig(**kw), device="cpu")))
    _, hot = next(iter(mri.DataLoader(mri.DataLoaderConfig(**kw, one_hot=True), device="cpu")))
    assert hot.dtype == torch.float32
    np.testing.assert_array_equal(hot.numpy(), np.asarray(jax.nn.one_hot(lab.numpy(), 3)))
