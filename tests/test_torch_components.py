"""Port connected components (repro_torch.core.components) against
repro.core.components, bit for bit, on seeded random masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import components as ref_components
from repro_torch.core import components

SHAPE = (12, 13, 14)


def _mask(seed, density):
    return np.random.default_rng(seed).random(SHAPE) < density


@pytest.mark.parametrize("density", [0.0, 0.2, 0.31, 0.5, 1.0])
def test_connected_components_bit_equal(density):
    mask = _mask(int(density * 100), density)
    expect = np.asarray(ref_components.connected_components(jnp.asarray(mask)))
    got = components.connected_components(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    sizes = components.component_sizes(got)
    np.testing.assert_array_equal(
        sizes.numpy(), np.asarray(ref_components.component_sizes(jnp.asarray(expect)))
    )


def test_long_snake_converges():
    # one serpentine path through the volume: the worst case for
    # neighbour propagation, which pointer jumping shortens
    mask = np.zeros((1, 15, 15), bool)
    mask[0, ::2, :] = True
    mask[0, 1::4, -1] = True
    mask[0, 3::4, 0] = True
    got = components.connected_components(torch.from_numpy(mask))
    expect = np.asarray(ref_components.connected_components(jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), expect)
    assert set(np.unique(got.numpy())) == {-1, 0}


@pytest.mark.parametrize("density", [0.0, 0.3, 0.6])
def test_largest_component_bit_equal(density):
    mask = _mask(7, density)
    expect = np.asarray(ref_components.largest_component(jnp.asarray(mask)))
    got = components.largest_component(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("min_size", [1, 4, 64])
def test_remove_small_components_bit_equal(min_size):
    mask = _mask(8, 0.3)
    expect = np.asarray(ref_components.remove_small_components(jnp.asarray(mask), min_size))
    got = components.remove_small_components(torch.from_numpy(mask), min_size)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("num_classes", [2, 3])
def test_filter_segmentation_bit_equal(num_classes):
    seg = np.random.default_rng(9).integers(0, num_classes, SHAPE).astype(np.int32)
    expect = np.asarray(ref_components.filter_segmentation(jnp.asarray(seg), num_classes, 8))
    got = components.filter_segmentation(torch.from_numpy(seg), num_classes, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
