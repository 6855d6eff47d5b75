"""Sub-volume patching (repro_torch.core.patching) against the reference's
(repro.core.patching) on the same numpy-made volumes and weights: the
cube specs, split and merge, sub-volume inference (executor "torch"
against "xla", logits within 1e-4, the streaming executor's bound in
tests/test_executors.py:212-219, and equal segmentations), and fault F1:
an engine whose budget picks the sub-volume failsafe serves the request.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.core import patching as ref_patching
from repro.core import pipeline as ref_pipeline
from repro.serving.engine import SegmentationEngine as RefEngine
from repro.telemetry.budget import MemoryBudget as RefBudget
from repro_torch import bridge
from repro_torch.core import meshnet, patching, pipeline
from repro_torch.serving.engine import SegmentationEngine
from repro_torch.telemetry.budget import MemoryBudget

SMALL = dict(dilations=(1, 2, 4))
LOGITS_ATOL = 1e-4


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
        layers.append({
            "w": (rng.standard_normal((3, 3, 3, cin, c)) * np.sqrt(2.0 / (27 * cin))).astype(f32),
            "b": (0.1 * rng.standard_normal(c)).astype(f32),
            "bn_scale": (1.0 + 0.2 * rng.standard_normal(c)).astype(f32),
            "bn_bias": (0.1 * rng.standard_normal(c)).astype(f32),
            "bn_mean": (0.3 * rng.standard_normal(c)).astype(f32),
            "bn_var": (0.5 + rng.random(c)).astype(f32),
        })
        cin = c
    head = {
        "w": (rng.standard_normal((1, 1, 1, c, cfg.num_classes)) * np.sqrt(2.0 / c)).astype(f32),
        "b": (0.1 * rng.standard_normal(cfg.num_classes)).astype(f32),
    }
    return {"layers": layers, "head": head}


def _volume(shape, seed):
    """A raw brain-like volume: a noisy bright ellipsoid on a dark field."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((zz / 0.6) ** 2 + (yy / 0.8) ** 2 + (xx / 0.7) ** 2)
    vol = np.where(r < 1.0, 120.0 - 60.0 * r, 5.0) + 8.0 * rng.standard_normal(shape)
    return vol.astype(np.float32)


@pytest.mark.parametrize(
    "shape,cube,overlap",
    [((16, 16, 16), 8, 4), ((10, 12, 14), 4, 3), ((20, 9, 33), 8, 5), ((256, 256, 256), 64, 46), ((7, 7, 7), 8, 0)],
)
def test_cube_divider_matches_reference(shape, cube, overlap):
    expect = ref_patching.CubeDivider(shape, cube=cube, overlap=overlap)
    got = patching.CubeDivider(shape, cube=cube, overlap=overlap)
    assert got.num_cubes == expect.num_cubes
    assert got.read_size == expect.read_size
    assert [tuple(getattr(s, f) for f in ("src_start", "dst_start", "trim_lo", "core")) for s in got.specs] == [
        tuple(getattr(s, f) for f in ("src_start", "dst_start", "trim_lo", "core")) for s in expect.specs
    ]


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("shape,cube,overlap", [((16, 16, 16), 8, 4), ((10, 12, 14), 4, 3), ((9, 5, 11), 8, 2)])
def test_split_then_merge_is_the_identity_on_the_core(shape, cube, overlap, channels):
    rng = np.random.default_rng(sum(shape))
    vol = rng.standard_normal(shape + ((channels,) if channels else ())).astype(np.float32)
    div = patching.CubeDivider(shape, cube=cube, overlap=overlap)
    cubes = div.split(torch.from_numpy(vol))
    assert all(tuple(c.shape[:3]) == div.read_size for c in cubes)
    ref_cubes = ref_patching.CubeDivider(shape, cube=cube, overlap=overlap).split(jnp.asarray(vol))
    for c, e in zip(cubes, ref_cubes):
        np.testing.assert_array_equal(c.numpy(), np.asarray(e))
    merged = div.merge(cubes)
    np.testing.assert_array_equal(merged.numpy(), vol)


def test_split_keeps_int8_and_bf16():
    vol = torch.arange(4 * 5 * 6, dtype=torch.int8).reshape(4, 5, 6)
    div = patching.CubeDivider((4, 5, 6), cube=4, overlap=2)
    for t in (vol, vol.to(torch.bfloat16)):
        cubes = div.split(t)
        assert cubes[0].dtype == t.dtype
        assert torch.equal(div.merge(cubes), t)


@pytest.mark.parametrize("batch_cubes", [1, 3])
def test_subvolume_inference_matches_reference(batch_cubes):
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    tree = _np_params(ref_cfg, seed=1)
    x = np.random.default_rng(2).random((16, 16, 16)).astype(np.float32)
    expect = ref_patching.subvolume_inference(
        jnp.asarray(x), params=jax.tree.map(jnp.asarray, tree), model_cfg=ref_cfg, executor="xla",
        cube=8, overlap=4, batch_cubes=batch_cubes,
    )
    cfg = meshnet.MeshNetConfig(**SMALL)
    got = patching.subvolume_inference(
        torch.from_numpy(x), params=bridge.params_from_numpy(tree, "cpu"), model_cfg=cfg, executor="torch",
        cube=8, overlap=4, batch_cubes=batch_cubes,
    )
    assert got.shape == (16, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=LOGITS_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(jnp.argmax(expect, -1)))
    # the tail batch is padded (8 cubes in batches of 3), not dropped
    one = patching.subvolume_inference(
        torch.from_numpy(x), params=bridge.params_from_numpy(tree, "cpu"), model_cfg=cfg, executor="torch",
        cube=8, overlap=4,
    )
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=LOGITS_ATOL)


def test_subvolume_inference_takes_infer_fn_or_params_not_both():
    cfg = meshnet.MeshNetConfig(**SMALL)
    params = bridge.params_from_numpy(_np_params(cfg, seed=3), "cpu")
    x = torch.rand((8, 8, 8))
    with pytest.raises(ValueError, match="infer_fn"):
        patching.subvolume_inference(x)
    with pytest.raises(ValueError, match="not both"):
        patching.subvolume_inference(x, lambda c: c, params=params, model_cfg=cfg)
    # an explicit closure sees (B, d, h, w) cubes of the read size
    seen = []

    def infer(c):
        seen.append(tuple(c.shape))
        return torch.stack([c, -c], -1)

    out = patching.subvolume_inference(x, infer, cube=4, overlap=2, batch_cubes=8)
    assert seen == [(8, 8, 8, 8)] and torch.equal(out[..., 0], x)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
def test_memory_models_match_reference(precision):
    from repro.kernels import quantize as ref_quantize

    b = ref_quantize.act_bytes(precision)
    assert patching.memory_bytes_full_volume((256,) * 3, 5, 3, b) == ref_patching.memory_bytes_full_volume((256,) * 3, 5, 3, b)
    assert patching.memory_bytes_subvolume(64, 46, 21, 104, b) == ref_patching.memory_bytes_subvolume(64, 46, 21, 104, b)
    assert patching.MESHNET_RF_RADIUS == ref_patching.MESHNET_RF_RADIUS == sum(meshnet.MeshNetConfig().dilations)


def test_f1_probe_the_failsafe_serves():
    """Fault F1: with MemoryBudget(bytes_limit=1024) at 16^3, pick_mode
    answers "subvolume" (two live activations need 212,992 bytes), and the
    request is served in that mode, as the reference serves it: cubes of 2
    without overlap need 416 bytes each (budget.charge_subvolume)."""
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    tree = _np_params(ref_cfg, seed=4)
    vol = _volume((16, 16, 16), seed=5)
    kw = dict(volume_shape=(16, 16, 16), cube=2, overlap=0, batch_cubes=64, min_component_size=4)
    ref_engine = RefEngine(
        jax.tree.map(jnp.asarray, tree), ref_pipeline.PipelineConfig(model=ref_cfg, executor="xla", **kw),
        budget=RefBudget(bytes_limit=1024),
    )
    engine = SegmentationEngine(
        bridge.params_from_numpy(tree, "cpu"), pipeline.PipelineConfig(model=meshnet.MeshNetConfig(**SMALL), **kw),
        budget=MemoryBudget(bytes_limit=1024), device="cpu",
    )
    assert engine.pick_mode((16, 16, 16)) == ref_engine.pick_mode((16, 16, 16)) == "subvolume"
    expect = ref_engine.submit(jnp.asarray(vol))
    got = engine.submit(vol)
    assert got.record.status == expect.record.status == "ok", (got.record.fail_type, expect.record.fail_type)
    assert got.record.mode == expect.record.mode == "subvolume"
    assert got.record.memory_budget_bytes == 1024
    np.testing.assert_array_equal(got.segmentation.numpy(), np.asarray(expect.segmentation))
    # at the pipeline's default cube the failsafe's own budget fails typed
    big = SegmentationEngine(
        bridge.params_from_numpy(tree, "cpu"),
        pipeline.PipelineConfig(model=meshnet.MeshNetConfig(**SMALL), volume_shape=(16, 16, 16), min_component_size=4),
        budget=MemoryBudget(bytes_limit=1024), device="cpu",
    )
    res = big.submit(vol)
    assert res.record.status == "fail" and res.record.fail_type == "subvolume_oom" and res.segmentation is None
