"""Port MeshNet (repro_torch.core.meshnet) against the reference
(repro.core.meshnet) on the same numpy-made weights and inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro_torch import bridge
from repro_torch.core import meshnet

ODD_SHAPE = (1, 10, 12, 14)


def np_params(cfg, seed):
    """MeshNet params made with numpy, with non-trivial BN statistics."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    layers, cin, c = [], cfg.in_channels, cfg.channels
    for _ in cfg.dilations:
        layer = {
            "w": (rng.standard_normal((3, 3, 3, cin, c)) * np.sqrt(2.0 / (27 * cin))).astype(f32),
            "b": (0.1 * rng.standard_normal(c)).astype(f32),
        }
        if cfg.use_batchnorm:
            layer["bn_scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(f32)
            layer["bn_bias"] = (0.1 * rng.standard_normal(c)).astype(f32)
            layer["bn_mean"] = (0.3 * rng.standard_normal(c)).astype(f32)
            layer["bn_var"] = (0.5 + rng.random(c)).astype(f32)
        layers.append(layer)
        cin = c
    head = {
        "w": (rng.standard_normal((1, 1, 1, c, cfg.num_classes)) * np.sqrt(2.0 / c)).astype(f32),
        "b": (0.1 * rng.standard_normal(cfg.num_classes)).astype(f32),
    }
    return {"layers": layers, "head": head}


def _port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(meshnet.MeshNetConfig)}
    return meshnet.MeshNetConfig(**fields)


def _logits_both(ref_cfg, seed, shape=ODD_SHAPE):
    tree = np_params(ref_cfg, seed)
    x = np.random.default_rng(seed + 100).standard_normal(shape).astype(np.float32)
    expect = np.asarray(ref_meshnet.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg))
    got = meshnet.apply(bridge.params_from_numpy(tree, "cpu"), torch.from_numpy(x), _port_cfg(ref_cfg))
    return got.numpy(), expect


def test_paper_models_match_field_for_field():
    assert set(meshnet.PAPER_MODELS) == set(ref_meshnet.PAPER_MODELS)
    port_fields = {f.name for f in dataclasses.fields(meshnet.MeshNetConfig)}
    ref_fields = {f.name for f in dataclasses.fields(ref_meshnet.MeshNetConfig)}
    assert port_fields == ref_fields - {"dtype"}
    for name, ref_cfg in ref_meshnet.PAPER_MODELS.items():
        cfg = meshnet.PAPER_MODELS[name]
        for f in port_fields:
            assert getattr(cfg, f) == getattr(ref_cfg, f), (name, f)
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.num_layers == ref_cfg.num_layers


@pytest.mark.parametrize("name", sorted(ref_meshnet.PAPER_MODELS))
def test_eval_logits_match_reference(name):
    got, expect = _logits_both(ref_meshnet.PAPER_MODELS[name], seed=3)
    assert got.shape == expect.shape == ODD_SHAPE + (ref_meshnet.PAPER_MODELS[name].num_classes,)
    np.testing.assert_allclose(got, expect, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), expect.argmax(-1))


def test_no_batchnorm_and_batch_axis():
    ref_cfg = ref_meshnet.MeshNetConfig(dilations=(1, 2, 4), use_batchnorm=False)
    got, expect = _logits_both(ref_cfg, seed=5, shape=(2, 9, 11, 7, 1))
    np.testing.assert_allclose(got, expect, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), expect.argmax(-1))


def test_predict_and_module_forward_equal_apply():
    cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
    params = bridge.params_from_numpy(np_params(cfg, seed=7), "cpu")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(ODD_SHAPE).astype(np.float32))
    logits = meshnet.apply(params, x, cfg)
    module = meshnet.MeshNet(cfg, params)
    assert torch.equal(module(x), logits)
    assert torch.equal(meshnet.predict(params, x, cfg), torch.argmax(logits, -1).to(torch.int32))
    tree = module.params()
    assert tree["layers"][0]["bn_var"] is params["layers"][0]["bn_var"]
    assert {n for n, _ in module.named_buffers()} >= {"layers.0.bn_mean", "layers.0.bn_var"}


def test_init_matches_reference_tree_shapes():
    cfg = meshnet.MeshNetConfig(channels=10, num_classes=50)
    ours = bridge.params_to_numpy(
        meshnet.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    )
    ref = jax.eval_shape(
        lambda key: ref_meshnet.init(key, ref_meshnet.PAPER_MODELS["atlas_50"]), jax.random.PRNGKey(0)
    )
    shapes = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)), ours)
    assert shapes == jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)), ref)
    # same seed, same numbers; He scale
    again = meshnet.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"][3]["w"], torch.from_numpy(ours["layers"][3]["w"]))
    std = float(np.std(ours["layers"][1]["w"]))
    assert abs(std - np.sqrt(2.0 / (27 * 10))) < 0.01


def test_init_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        meshnet.init(meshnet.MeshNetConfig())
