"""The streaming executor (repro_torch.core.streaming) against the
reference's (repro.core.streaming) on the same numpy-made weights and
conformed inputs, and its registry entry and byte model.

Bounds: fp32 logits within 1e-4 (tests/test_executors.py:212-219); bf16
within 1e-3 and int8w within 2e-2 of the reference's streaming forward,
the bounds between the reference's own backends
(tests/test_precision.py:85, :112).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executors as ref_executors
from repro.core import meshnet as ref_meshnet
from repro.core import streaming as ref_streaming
from repro.telemetry import traffic as ref_traffic
from repro_torch import bridge
from repro_torch.core import executors, meshnet, streaming
from repro_torch.telemetry import traffic

ODD_SHAPE = (1, 10, 12, 14)
SMALL = dict(dilations=(1, 2, 4))
GATES = {"fp32": 1e-4, "bf16": 1e-3, "int8w": 2e-2}


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


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize(
    "kw,shape",
    [
        (SMALL, ODD_SHAPE),
        (dict(SMALL, use_batchnorm=False), ODD_SHAPE),
        (dict(dilations=(1, 2, 4, 8, 16, 8, 4, 2, 1)), (2, 9, 17, 13)),
    ],
    ids=["default", "no_bn", "full_schedule_batched"],
)
def test_streaming_apply_matches_reference(kw, shape, precision):
    ref_cfg = ref_meshnet.MeshNetConfig(**kw)
    tree = _np_params(ref_cfg, seed=1)
    x = np.random.default_rng(2).random(shape).astype(np.float32)  # conformed: [0, 1]
    expect = ref_streaming.streaming_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg, precision)
    got = streaming.streaming_apply(bridge.params_from_numpy(tree, "cpu"), torch.from_numpy(x), _port_cfg(ref_cfg), precision)
    assert got.shape == tuple(expect.shape)
    assert got.dtype == (torch.float32 if precision == "fp32" else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), atol=GATES[precision])
    if precision == "fp32":  # the function of meshnet.apply
        plain = meshnet.apply(bridge.params_from_numpy(tree, "cpu"), torch.from_numpy(x), _port_cfg(ref_cfg))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=GATES["fp32"])


def test_stack_layer_params_matches_reference():
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    tree = _np_params(ref_cfg, seed=3)
    e_first, e_middle, e_head = ref_streaming.stack_layer_params(jax.tree.map(jnp.asarray, tree))
    first, middle, head = streaming.stack_layer_params(bridge.params_from_numpy(tree, "cpu"))
    assert sorted(middle) == sorted(e_middle)
    for k in middle:
        np.testing.assert_array_equal(middle[k].numpy(), np.asarray(e_middle[k]))
    np.testing.assert_array_equal(first["w"].numpy(), np.asarray(e_first["w"]))
    np.testing.assert_array_equal(head["w"].numpy(), np.asarray(e_head["w"]))
    one = streaming.stack_layer_params({"layers": tree["layers"][:1], "head": tree["head"]})
    assert one[1] is None


def test_one_layer_model_streams():
    cfg = meshnet.MeshNetConfig(dilations=(2,))
    params = bridge.params_from_numpy(_np_params(cfg, seed=4), "cpu")
    x = torch.rand((1, 6, 7, 8), generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(streaming.streaming_apply(params, x, cfg).numpy(), meshnet.apply(params, x, cfg).numpy(), atol=1e-5)


def test_streaming_is_registered_as_the_references():
    assert executors.REFERENCE_NAMES["streaming"] == "streaming"
    assert set(executors.REFERENCE_NAMES) == set(executors.names())
    for ours, theirs in executors.REFERENCE_NAMES.items():
        assert theirs in ref_executors.names()
    spec = executors.get("streaming")
    assert spec.apply is streaming.streaming_apply and spec.streaming_apply is streaming.streaming_apply
    # mode "streaming" under the plain executor runs this schedule, as the
    # reference's "xla" runs its streaming_apply
    assert executors.get("torch").streaming_apply is streaming.streaming_apply


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("name", sorted(ref_meshnet.PAPER_MODELS))
def test_streaming_bytes_match_reference_and_are_batch_aware(name, precision):
    ref_cfg, cfg = ref_meshnet.PAPER_MODELS[name], meshnet.PAPER_MODELS[name]
    for vol in ((256, 256, 256), (10, 12, 14)):
        for batch in (1, 3):
            expect = ref_traffic.meshnet_streaming_bytes(ref_cfg, vol, batch=batch, precision=precision)
            assert traffic.meshnet_streaming_bytes(cfg, vol, batch=batch, precision=precision) == expect
        for fn in (traffic.meshnet_streaming_bytes, traffic.meshnet_fused_bytes):
            one = fn(cfg, vol, precision=precision)
            assert fn(cfg, vol, batch=3, precision=precision) < 3 * one
    # the fused model at the policy's widths: activations halve; at an
    # empty volume only the weights are left, and int8 taps quarter them
    # (biases, BN vectors and the bf16 head keep theirs)
    assert traffic.meshnet_fused_bytes(cfg, (256,) * 3, precision="bf16") < 0.51 * traffic.meshnet_fused_bytes(cfg, (256,) * 3)
    w32, w8 = (traffic.meshnet_fused_bytes(cfg, (0, 0, 0), precision=p) for p in ("fp32", "int8w"))
    assert w8 < w32 / 3
