"""Port cropping (repro_torch.core.cropping) against repro.core.cropping."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cropping as ref_cropping
from repro_torch.core import cropping

SHAPE = (20, 18, 16)
LADDER = ((6, 6, 6), (10, 10, 10), (14, 14, 14), (20, 20, 20))


def _box_mask(lo, hi):
    m = np.zeros(SHAPE, bool)
    m[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]] = True
    return m


MASKS = {
    "empty": np.zeros(SHAPE, bool),
    "centre": _box_mask((6, 5, 4), (12, 11, 10)),
    "corner": _box_mask((0, 0, 0), (3, 4, 2)),
    "far_edge": _box_mask((15, 10, 12), (20, 18, 16)),
    "scattered": np.random.default_rng(0).random(SHAPE) < 0.01,
}


@pytest.mark.parametrize("name", sorted(MASKS))
def test_mask_bounding_box(name):
    mask = MASKS[name]
    lo, hi = cropping.mask_bounding_box(torch.from_numpy(mask))
    rlo, rhi = ref_cropping.mask_bounding_box(jnp.asarray(mask))
    assert lo.tolist() == np.asarray(rlo).tolist()
    assert hi.tolist() == np.asarray(rhi).tolist()


@pytest.mark.parametrize("margin", [0, 2, 4])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_pick_crop_size(name, margin):
    mask = MASKS[name]
    got = cropping.pick_crop_size(torch.from_numpy(mask), LADDER, margin=margin)
    expect = ref_cropping.pick_crop_size(jnp.asarray(mask), LADDER, margin=margin)
    assert got == tuple(int(s) for s in expect)
    assert cropping.pick_crop_size(torch.from_numpy(mask)) == ref_cropping.pick_crop_size(jnp.asarray(mask))


@pytest.mark.parametrize("size", [(6, 6, 6), (10, 8, 14), (20, 18, 16)])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_crop_to_and_uncrop(name, size):
    mask = MASKS[name]
    vol = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    crop, start = cropping.crop_to(torch.from_numpy(vol), torch.from_numpy(mask), size)
    rcrop, rstart = ref_cropping.crop_to(jnp.asarray(vol), jnp.asarray(mask), size)
    assert start == tuple(int(s) for s in np.asarray(rstart))
    np.testing.assert_array_equal(crop.numpy(), np.asarray(rcrop))
    seg = (crop > 0).to(torch.int32)
    back = cropping.uncrop(seg, start, SHAPE)
    rback = ref_cropping.uncrop(jnp.asarray(seg.numpy()), rstart, SHAPE)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(rback))


def test_ladder_matches_reference():
    assert cropping.CROP_LADDER == ref_cropping.CROP_LADDER
