"""Port conform (repro_torch.core.conform) against repro.core.conform."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conform as ref_conform
from repro_torch.core import conform

TOL = 1e-6


def test_conform_non_cubic_volume_matches_reference():
    rng = np.random.default_rng(0)
    vol = (rng.random((12, 14, 9)) * 300.0).astype(np.float32)
    vol[3, 4, 5] = np.nan
    vol[0, 0, 0] = np.inf
    voxel_size = (1.25, 1.0, 0.8)
    expect = np.asarray(ref_conform.conform(jnp.asarray(vol), (16, 16, 16), voxel_size))
    got = conform.conform(torch.from_numpy(vol), (16, 16, 16), voxel_size)
    assert got.shape == (16, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, atol=TOL)


def test_resample_matches_reference():
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((7, 10, 13)).astype(np.float32)
    expect = np.asarray(ref_conform.resample(jnp.asarray(vol), (9, 8, 11), (0.7, 1.3, 1.0)))
    got = conform.resample(torch.from_numpy(vol), (9, 8, 11), (0.7, 1.3, 1.0))
    np.testing.assert_allclose(got.numpy(), expect, atol=TOL)


def test_cubic_volume_is_only_rescaled():
    rng = np.random.default_rng(2)
    vol = rng.gamma(2.0, 50.0, (8, 8, 8)).astype(np.float32)
    expect = np.asarray(ref_conform.conform(jnp.asarray(vol), (8, 8, 8)))
    got = conform.conform(torch.from_numpy(vol), (8, 8, 8))
    np.testing.assert_allclose(got.numpy(), expect, atol=TOL)
    assert float(got.min()) == 0.0 and float(got.max()) == 1.0


@pytest.mark.parametrize(
    "fill", [0.0, 7.5, np.nan], ids=["all_zero", "constant", "all_nan"]
)
def test_degenerate_volume_raises(fill):
    vol = torch.full((6, 7, 8), fill)
    with pytest.raises(conform.DegenerateVolumeError):
        conform.conform(vol, (8, 8, 8))
    with pytest.raises(ref_conform.DegenerateVolumeError):
        ref_conform.conform(jnp.asarray(vol.numpy()), (8, 8, 8))


def test_quantiles_above_torch_quantile_limit():
    # 2**24 + 1 elements: more than torch.quantile accepts.
    x = np.random.default_rng(3).random(2**24 + 1, dtype=np.float32)
    qs = (0.01, 0.5, 0.99)
    for got, q in zip(conform.quantiles(torch.from_numpy(x), qs), qs):
        assert abs(float(got) - float(np.quantile(x, q))) <= TOL


def test_quantiles_match_jnp_quantile_on_small_input():
    x = np.random.default_rng(4).standard_normal(1001).astype(np.float32)
    qs = (0.0, 0.01, 0.37, 0.99, 1.0)
    for got, q in zip(conform.quantiles(torch.from_numpy(x), qs), qs):
        assert abs(float(got) - float(jnp.quantile(jnp.asarray(x), q))) <= TOL
