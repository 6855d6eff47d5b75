"""The port's precision policy (repro_torch.kernels.quantize) and K1r's
plain version against the reference's (repro.kernels.quantize and the
Pallas K1 in interpret mode) on the same numpy-made weights and inputs.

Bounds, each stated where it is used:
- the int8 codes, their scales and the prepared trees: bit-equal (both
  divide in fp32 and round half to even);
- the folded epilogue: 1e-6 relative (rsqrt in each framework);
- the reduced forwards: within 1e-3 at bf16 and 2e-2 at int8w of the
  reference's, the bounds between the reference's own backends
  (tests/test_precision.py:85, :112), on the 5-channel configurations
  those tests use; the wide paper models, whose logits pass 1, within one
  bf16 step at the logits' largest magnitude;
- K1r's plain version against the Pallas K1 at bf16: one bf16 step at
  the layer's largest magnitude, since both round an fp32 sum taken in
  its own order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.kernels import dilated_conv3d as ref_conv_kernel
from repro.kernels import quantize as ref_quantize
from repro_torch import bridge, tree
from repro_torch.core import executors, meshnet
from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import quantize

ODD_SHAPE = (1, 10, 12, 14)
SMALL = dict(dilations=(1, 2, 4))
BF16_STEP = 2.0**-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with a test worker on every core, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_params(cfg, seed):
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


def _np(t):
    return np.asarray(t)


def _assert_trees_bit_equal(got, expect):
    """Same structure, dtypes and bits (bf16 compared through its bits)."""
    got_leaves = tree.leaves_with_paths(bridge.params_to_numpy(got))
    expect_leaves = tree.leaves_with_paths(jax.tree.map(np.asarray, expect))
    got_leaves, expect_leaves = list(got_leaves), list(expect_leaves)
    assert [p for p, _ in got_leaves] == [p for p, _ in expect_leaves]
    for (path, g), (_, e) in zip(got_leaves, expect_leaves):
        assert g.dtype == e.dtype, (path, g.dtype, e.dtype)
        assert g.shape == e.shape, path
        assert g.tobytes() == e.tobytes(), path


@pytest.mark.parametrize("shape,axis", [((3, 3, 3, 5, 5), -1), ((3, 3, 3, 21, 21), -1), ((7, 4), 0)])
def test_quantize_symmetric_is_bit_equal(shape, axis):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    index = [slice(None)] * len(shape)
    index[axis] = 1
    w[tuple(index)] = 0.0  # a zero slice gets scale 1
    q_ref, s_ref = ref_quantize.quantize_symmetric(jnp.asarray(w), axis=axis)
    q, s = quantize.quantize_symmetric(torch.from_numpy(w), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), _np(q_ref))
    assert s.numpy().tobytes() == _np(s_ref).tobytes()
    assert float(s[1]) == 1.0
    back = quantize.dequantize(q, s, axis=axis)
    np.testing.assert_allclose(back.numpy(), _np(ref_quantize.dequantize(q_ref, s_ref, axis=axis)), rtol=0, atol=0)
    bound = quantize.roundtrip_bound(s)
    shape_b = [1] * len(shape)
    shape_b[axis] = shape[axis]
    assert bool(((back - torch.from_numpy(w)).abs() <= bound.reshape(shape_b)).all())


def test_quantize_input_is_bit_equal_and_rounds_half_to_even():
    rng = np.random.default_rng(0)
    x = rng.random((6, 7, 8)).astype(np.float32)
    x.flat[:6] = [0.0, 1.0, 0.5 / 127, 1.5 / 127, 2.5 / 127, 126.5 / 127]
    got = quantize.quantize_input(torch.from_numpy(x))
    expect = _np(ref_quantize.quantize_input(jnp.asarray(x)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), expect)
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5])), torch.tensor([0.0, 2.0, 2.0]))


@pytest.mark.parametrize("precision", ["bf16", "int8w"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
def test_prepare_params_is_bit_equal_and_idempotent(precision, bn):
    ref_cfg = ref_meshnet.MeshNetConfig(use_batchnorm=bn, **SMALL)
    np_tree = _np_params(ref_cfg, seed=1)
    expect = ref_quantize.prepare_params(jax.tree.map(jnp.asarray, np_tree), ref_cfg, precision)
    cfg = _port_cfg(ref_cfg)
    got = quantize.prepare_params(bridge.params_from_numpy(np_tree, "cpu"), cfg, precision)
    _assert_trees_bit_equal(got, expect)
    assert quantize.is_prepared(got, precision) and not quantize.is_prepared(got, "bf16" if precision == "int8w" else "int8w")
    assert quantize.prepare_params(got, cfg, precision) is got
    assert quantize.params_bytes(got) == ref_quantize.params_bytes(expect) == quantize.model_params_bytes(cfg, precision)


def test_prepared_trees_cross_the_bridge_bit_equal_both_ways():
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    np_tree = _np_params(ref_cfg, seed=2)
    for precision in ("bf16", "int8w"):
        ref_tree = jax.tree.map(np.asarray, ref_quantize.prepare_params(jax.tree.map(jnp.asarray, np_tree), ref_cfg, precision))
        port = bridge.params_from_numpy(ref_tree, "cpu")
        assert port["head"]["w"].dtype == torch.bfloat16
        assert port["layers"][0]["w"].dtype == (torch.int8 if precision == "int8w" else torch.bfloat16)
        back = bridge.params_to_numpy(port)
        for (path, a), (_, b) in zip(tree.leaves_with_paths(back), tree.leaves_with_paths(ref_tree)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
        assert back["head"]["w"].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
def test_fold_epilogue_matches_reference(precision, bn):
    ref_cfg = ref_meshnet.MeshNetConfig(use_batchnorm=bn, **SMALL)
    np_tree = _np_params(ref_cfg, seed=3)
    ref_layer = ref_quantize.prepare_params(jax.tree.map(jnp.asarray, np_tree), ref_cfg, precision)["layers"][1]
    layer = quantize.prepare_params(bridge.params_from_numpy(np_tree, "cpu"), _port_cfg(ref_cfg), precision)["layers"][1]
    expect = ref_quantize.fold_epilogue(ref_layer, bn)
    got = quantize.fold_epilogue(layer, bn)
    for g, e in zip(got, expect):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(e), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", sorted(ref_meshnet.PAPER_MODELS))
def test_model_params_bytes_every_policy(name):
    for precision in quantize.PRECISIONS:
        expect = ref_quantize.model_params_bytes(ref_meshnet.PAPER_MODELS[name], precision)
        assert quantize.model_params_bytes(meshnet.PAPER_MODELS[name], precision) == expect
    for role in ("act_bytes", "weight_bytes", "input_bytes", "staging_bytes"):
        for precision in quantize.PRECISIONS:
            assert getattr(quantize, role)(precision) == getattr(ref_quantize, role)(precision)


def _reduced_pair(ref_cfg, precision, seed=4):
    np_tree = _np_params(ref_cfg, seed=seed)
    x = np.random.default_rng(seed + 1).random(ODD_SHAPE).astype(np.float32)  # conformed: [0, 1]
    ref_params = ref_quantize.prepare_params(jax.tree.map(jnp.asarray, np_tree), ref_cfg, precision)
    expect = np.asarray(ref_quantize.reference_apply(ref_params, jnp.asarray(x), ref_cfg, precision), np.float32)
    cfg = _port_cfg(ref_cfg)
    params = bridge.params_from_numpy(np_tree, "cpu")
    got = quantize.reference_apply(params, torch.from_numpy(x), cfg, precision)
    fused = executors.apply("cuda_fused", params, torch.from_numpy(x), cfg, precision=precision)
    assert got.dtype == fused.dtype == torch.bfloat16 and got.shape == expect.shape
    return params, cfg, x, got, fused, expect


@pytest.mark.parametrize("precision,atol", [("bf16", 1e-3), ("int8w", 2e-2)])
@pytest.mark.parametrize(
    "kw",
    [SMALL, dict(SMALL, use_batchnorm=False), dict(ref_meshnet.PAPER_MODELS["brain_mask_fast"].__dict__, **SMALL)],
    ids=["default", "no_bn", "brain_mask_fast"],
)
def test_reference_apply_matches_reference(kw, precision, atol):
    # the reference's own gates between its backends, on the 5-channel
    # configurations its precision tests use
    params, cfg, x, got, fused, expect = _reduced_pair(ref_meshnet.MeshNetConfig(**kw), precision)
    np.testing.assert_allclose(got.float().numpy(), expect, atol=atol)
    # the fused forward (K1r's plain version on the CPU) computes the same
    np.testing.assert_allclose(fused.float().numpy(), expect, atol=atol)
    # an int8 input is taken as already on the conformed int8 grid
    if precision == "int8w":
        again = quantize.reference_apply(params, quantize.quantize_input(torch.from_numpy(x)), cfg, precision)
        assert torch.equal(again, got)


@pytest.mark.parametrize("precision", ["bf16", "int8w"])
@pytest.mark.parametrize("name", ["gwm_large", "atlas_104"])
def test_reference_apply_wide_models(name, precision):
    # wider models have logits past 1, where one bf16 step exceeds those
    # gates; each package rounds its own fp32 sums, so the bound is one
    # bf16 step at the logits' largest magnitude (2^-7 of it)
    _, _, _, got, fused, expect = _reduced_pair(dataclasses.replace(ref_meshnet.PAPER_MODELS[name], **SMALL), precision)
    bound = 2.0**-7 * np.max(np.abs(expect))
    assert np.max(np.abs(got.float().numpy() - expect)) <= bound
    assert np.max(np.abs(fused.float().numpy() - expect)) <= bound


def test_auto_is_fp32_on_every_device():
    for model in (None, meshnet.PAPER_MODELS["gwm_light"], meshnet.PAPER_MODELS["atlas_104"]):
        assert quantize.resolve_precision("auto", model) == "fp32"
        assert quantize.resolve_precision(None, model) == "fp32"
    assert quantize.act_dtype("int8w") == quantize.act_dtype("bf16") == torch.bfloat16


def test_plain_k1r_against_pallas_k1_interpret():
    # The TPU kernel itself at bf16, one fused layer at 8^3, block 8, in
    # interpret mode; K1r's wrapper on the CPU (its plain version).
    rng = np.random.default_rng(6)
    x = np.maximum(rng.standard_normal((1, 8, 8, 8, 5)), 0).astype(ml_dtypes.bfloat16)
    w = (rng.standard_normal((3, 3, 3, 5, 5)) * 0.2).astype(ml_dtypes.bfloat16)
    b = (rng.standard_normal(5) * 0.1).astype(np.float32)
    s = (0.5 + rng.random(5)).astype(np.float32)
    o = (rng.standard_normal(5) * 0.1).astype(np.float32)
    expect = ref_conv_kernel.dilated_conv3d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=2,
        scale=jnp.asarray(s), offset=jnp.asarray(o), fuse_affine=True, block=8, interpret=True,
    )
    assert expect.dtype == jnp.bfloat16
    t = bridge.params_from_numpy({"x": x, "w": w, "b": b, "s": s, "o": o}, "cpu")
    before = (conv_kernel.launches, conv_kernel.reduced_launches)
    got = conv_kernel.dilated_conv3d(t["x"], t["w"], t["b"], dilation=2, scale=t["s"], offset=t["o"], fuse_affine=True)
    assert (conv_kernel.launches, conv_kernel.reduced_launches) == before  # the CPU path launches nothing
    assert got.dtype == torch.bfloat16
    e = np.asarray(expect, np.float32)
    assert np.max(np.abs(got.float().numpy() - e)) <= BF16_STEP * np.max(np.abs(e))
