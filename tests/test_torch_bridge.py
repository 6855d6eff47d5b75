"""The numpy bridge between the reference package and the PyTorch port:
params and volumes survive numpy -> port -> numpy bit for bit."""

import jax
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.training import optimizer as ref_opt
from repro_torch import bridge, tree
from repro_torch.training import optimizer as opt


def _ref_params(cfg):
    """A params tree of the reference's structure, filled from numpy."""
    shapes = jax.eval_shape(lambda key: ref_meshnet.init(key, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_params_round_trip_bit_equal(use_batchnorm):
    tree = _ref_params(ref_meshnet.MeshNetConfig(dilations=(1, 2), use_batchnorm=use_batchnorm))
    ported = bridge.params_from_numpy(tree, device="cpu")
    assert isinstance(ported["layers"][0]["w"], torch.Tensor)
    assert ported["layers"][0]["w"].device.type == "cpu"
    back = bridge.params_to_numpy(ported)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_params_are_copies():
    tree = _ref_params(ref_meshnet.MeshNetConfig(dilations=(1,)))
    ported = bridge.params_from_numpy(tree, device="cpu")
    ported["head"]["b"].add_(1.0)
    assert not np.any(tree["head"]["b"] == ported["head"]["b"].numpy())


def test_volume_round_trip_bit_equal():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    vol[0, 0, 0, 0, 0] = np.nan
    t = bridge.volume_from_numpy(vol, device="cpu")
    assert t.shape == vol.shape and t.dtype == torch.float32
    np.testing.assert_array_equal(bridge.volume_to_numpy(t).view(np.uint32), vol.view(np.uint32))


def test_adamw_state_round_trip_keeps_the_namedtuple():
    """An optimizer state (a NamedTuple of int32 step and moment trees)
    crosses numpy -> port -> numpy bit-equal, as the same NamedTuple type;
    the port's own state crosses to numpy and back the same way."""
    params = _ref_params(ref_meshnet.MeshNetConfig(dilations=(1, 2)))
    ref_state = jax.tree.map(np.asarray, ref_opt.adamw_init(jax.tree.map(jax.numpy.asarray, params), ref_opt.AdamWConfig()))
    ref_state = ref_state._replace(mu=jax.tree.map(lambda a: a + 0.5, ref_state.mu))
    ported = bridge.params_from_numpy(ref_state, device="cpu")
    assert type(ported) is ref_opt.AdamWState and ported.step.dtype == torch.int32
    back = bridge.params_to_numpy(ported)
    assert type(back) is ref_opt.AdamWState
    for a, b in zip(jax.tree.leaves(ref_state), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))

    state = opt.adamw_init(bridge.params_from_numpy(params, device="cpu"), opt.AdamWConfig())
    as_numpy = bridge.params_to_numpy(state)
    assert type(as_numpy) is opt.AdamWState and as_numpy.step.dtype == np.int32
    again = bridge.params_from_numpy(as_numpy, device="cpu")
    assert type(again) is opt.AdamWState
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(again), tree.leaves(state)))


def test_lm_params_and_cache_round_trip_bit_equal_in_bf16():
    """The reference's TinyLlama smoke params in bf16 (a dict with a tuple
    of stacked block dicts) and a decode cache cross numpy -> port ->
    numpy bit-equal, in both directions, with their dtypes."""
    from repro import configs as ref_configs
    from repro.models import model as ref_model
    from repro_torch import configs
    from repro_torch.models import model

    cfg = ref_configs.get_smoke("tinyllama-1.1b")
    params = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0), cfg))
    cache = jax.tree.map(lambda a: np.asarray(a) + np.asarray(1.5, a.dtype), ref_model.init_cache(cfg, 2, 8))
    for ref_tree in (params, cache):
        ported = bridge.params_from_numpy(ref_tree, device="cpu")
        assert all(t.dtype == torch.bfloat16 for t in tree.leaves(ported))
        back = bridge.params_to_numpy(ported)
        flat_a, def_a = jax.tree.flatten(ref_tree)
        flat_b, def_b = jax.tree.flatten(back)
        assert def_a == def_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    own = model.init(configs.get_smoke("tinyllama-1.1b"), device="cpu")
    again = bridge.params_from_numpy(bridge.params_to_numpy(own), device="cpu")
    assert isinstance(again["blocks"], tuple)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(tree.leaves(again), tree.leaves(own)))
