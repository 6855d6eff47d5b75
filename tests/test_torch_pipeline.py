"""The slice as a whole: port pipeline.run and SegmentationEngine.submit
(executor "torch", device="cpu") against the reference's (executor "xla")
on the same numpy-made weights and volumes. Segmentations must be equal,
as tests/test_executors.py requires across the reference's backends."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executors as ref_executors
from repro.core import meshnet as ref_meshnet
from repro.core import pipeline as ref_pipeline
from repro.serving.engine import SegmentationEngine as RefEngine
from repro.telemetry.budget import MemoryBudget as RefBudget
from repro_torch import bridge
from repro_torch.core import executors, meshnet, pipeline
from repro_torch.serving.engine import SegmentationEngine
from repro_torch.telemetry.budget import MemoryBudget

SMALL = dict(dilations=(1, 2, 4))
MAIN = dict(SMALL, channels=5, num_classes=3)
MASK = dict(SMALL, channels=5, num_classes=2)


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


def _threshold_params(thresholds):
    """One layer, no BN, that passes the intensity through channel 0; the
    head's class logits are 0.3, x and 2x - 0.9 (first len(thresholds)+1
    of them), so labels are intensity bands and every product is exact."""
    c, k = 5, len(thresholds) + 1
    w = np.zeros((3, 3, 3, 1, c), np.float32)
    w[1, 1, 1, 0, 0] = 1.0
    hw = np.zeros((1, 1, 1, c, k), np.float32)
    hb = np.zeros(k, np.float32)
    hb[0] = 0.3
    hw[0, 0, 0, 0, 1] = 1.0
    if k == 3:
        hw[0, 0, 0, 0, 2] = 2.0
        hb[2] = -0.9
    return {"layers": [{"w": w, "b": np.zeros(c, np.float32)}], "head": {"w": hw, "b": hb}}


def _volume(shape, seed):
    """A raw brain-like volume: a noisy bright ellipsoid on a dark field."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((zz / 0.6) ** 2 + (yy / 0.8) ** 2 + (xx / 0.7) ** 2)
    vol = np.where(r < 1.0, 120.0 - 60.0 * r, 5.0) + 8.0 * rng.standard_normal(shape)
    return vol.astype(np.float32)


def _both(model_kw, seed, mask_kw=None, mask_params=None, params=None):
    ref_cfg = ref_meshnet.MeshNetConfig(**model_kw)
    cfg = meshnet.MeshNetConfig(**model_kw)
    tree = params if params is not None else _np_params(cfg, seed)
    ref = dict(cfg=ref_cfg, params=jax.tree.map(jnp.asarray, tree))
    port = dict(cfg=cfg, params=bridge.params_from_numpy(tree, "cpu"))
    if mask_kw is not None:
        mtree = mask_params if mask_params is not None else _np_params(meshnet.MeshNetConfig(**mask_kw), seed + 1)
        ref["mask"] = (jax.tree.map(jnp.asarray, mtree), ref_meshnet.MeshNetConfig(**mask_kw))
        port["mask"] = (bridge.params_from_numpy(mtree, "cpu"), meshnet.MeshNetConfig(**mask_kw))
    else:
        ref["mask"] = port["mask"] = None
    return ref, port


def _assert_same_run(got, expect):
    assert got.record.status == expect.record.status == "ok", (got.record, expect.record)
    assert got.record.mode == expect.record.mode
    assert got.record.crop_size == expect.record.crop_size
    assert got.record.params_bytes == expect.record.params_bytes
    assert got.record.precision == expect.record.precision == "fp32"
    assert executors.REFERENCE_NAMES[got.record.executor] == expect.record.executor
    assert isinstance(got.segmentation, torch.Tensor) and got.segmentation.dtype == torch.int32
    np.testing.assert_array_equal(got.segmentation.numpy(), np.asarray(expect.segmentation))


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "mask_crop"])
@pytest.mark.parametrize("mode", ["full", "streaming"])
def test_pipeline_matches_reference(mode, with_mask):
    ref, port = _both(MAIN, seed=10, mask_kw=MASK if with_mask else None)
    vol = _volume((14, 16, 12), seed=11)  # non-cubic: conform resamples
    kw = dict(volume_shape=(16, 16, 16), mode=mode, use_cropping=with_mask, min_component_size=4)
    expect = ref_pipeline.run(
        ref_pipeline.PipelineConfig(model=ref["cfg"], executor="xla", **kw),
        ref["params"], jnp.asarray(vol), mask_model=ref["mask"],
    )
    got = pipeline.run(
        pipeline.PipelineConfig(model=port["cfg"], executor="torch", **kw),
        port["params"], vol, mask_model=port["mask"], device="cpu",
    )
    _assert_same_run(got, expect)
    assert got.segmentation.shape == (16, 16, 16)
    assert (got.record.crop_size is not None) == with_mask


def test_pipeline_crop_and_uncrop_match_reference():
    # Z is longer than the smallest crop on the ladder, so the crop is a
    # real (128, 32, 32) box and uncrop pastes it back at its offset.
    ref, port = _both(
        dict(dilations=(1,), num_classes=3, use_batchnorm=False), seed=0,
        mask_kw=dict(dilations=(1,), num_classes=2, use_batchnorm=False),
        params=_threshold_params((0.3, 0.9)), mask_params=_threshold_params((0.3,)),
    )
    vol = _volume((140, 32, 32), seed=12)
    kw = dict(volume_shape=(140, 32, 32), use_cropping=True, crop_margin=2, min_component_size=16)
    expect = ref_pipeline.run(
        ref_pipeline.PipelineConfig(model=ref["cfg"], executor="xla", **kw),
        ref["params"], jnp.asarray(vol), mask_model=ref["mask"],
    )
    got = pipeline.run(
        pipeline.PipelineConfig(model=port["cfg"], executor="torch", **kw),
        port["params"], vol, mask_model=port["mask"], device="cpu",
    )
    _assert_same_run(got, expect)
    assert got.record.crop_size == (128, 32, 32)
    seg = got.segmentation.numpy()
    assert set(np.unique(seg)) == {0, 1, 2}
    assert not seg[:2].any() and not seg[-2:].any()


def test_engine_submit_matches_reference():
    ref, port = _both(MAIN, seed=20, mask_kw=MASK)
    kw = dict(volume_shape=(16, 16, 16), use_cropping=True, min_component_size=4)
    ref_engine = RefEngine(
        ref["params"], ref_pipeline.PipelineConfig(model=ref["cfg"], executor="xla", **kw),
        mask_model=ref["mask"],
    )
    engine = SegmentationEngine(
        port["params"], pipeline.PipelineConfig(model=port["cfg"], **kw),
        mask_model=port["mask"], device="cpu",
    )
    assert engine.budget == MemoryBudget.h100()
    for i, shape in enumerate([(16, 16, 16), (14, 16, 12), (16, 16, 16)]):
        vol = _volume(shape, seed=30 + i)
        expect = ref_engine.submit(jnp.asarray(vol))
        got = engine.submit(vol)
        _assert_same_run(got, expect)
        assert got.record.mode == "streaming"
        assert got.record.executor == "torch"  # "auto" on the CPU
        assert got.record.memory_budget_bytes == 80 * 1024**3
    assert len(engine.log.records) == 3 and engine.log.success_rate() == 1.0


def test_cuda_fused_backend_on_cpu_gives_the_same_segmentation():
    _, port = _both(MAIN, seed=40)
    vol = _volume((16, 16, 16), seed=41)
    segs = {}
    for ex in ("torch", "cuda_fused"):
        pc = pipeline.PipelineConfig(model=port["cfg"], volume_shape=(16, 16, 16), executor=ex, min_component_size=4)
        res = pipeline.run(pc, port["params"], vol, device="cpu")
        assert res.record.executor == ex
        segs[ex] = res.segmentation
    assert torch.equal(segs["torch"], segs["cuda_fused"])


@pytest.mark.parametrize("fill", [0.0, 3.0, np.nan], ids=["all_zero", "constant", "all_nan"])
def test_degenerate_volume_fails_typed(fill):
    ref, port = _both(MAIN, seed=50)
    vol = np.full((16, 16, 16), fill, np.float32)
    got = pipeline.run(
        pipeline.PipelineConfig(model=port["cfg"], volume_shape=(16, 16, 16)), port["params"], vol, device="cpu"
    )
    expect = ref_pipeline.run(
        ref_pipeline.PipelineConfig(model=ref["cfg"], volume_shape=(16, 16, 16), executor="xla"),
        ref["params"], jnp.asarray(vol),
    )
    assert got.record.status == expect.record.status == "fail"
    assert got.record.fail_type == expect.record.fail_type == "degenerate_volume"
    assert got.segmentation is None


def test_budget_failure_fails_typed():
    ref, port = _both(MAIN, seed=51)
    vol = _volume((16, 16, 16), seed=52)
    got = pipeline.run(
        pipeline.PipelineConfig(model=port["cfg"], volume_shape=(16, 16, 16), budget=MemoryBudget(1024)),
        port["params"], vol, device="cpu",
    )
    expect = ref_pipeline.run(
        ref_pipeline.PipelineConfig(
            model=ref["cfg"], volume_shape=(16, 16, 16), executor="xla", budget=RefBudget(1024)
        ),
        ref["params"], jnp.asarray(vol),
    )
    assert got.record.fail_type == expect.record.fail_type == "full_volume_oom"
    assert got.record.memory_budget_bytes == 1024


def test_reference_names_map_to_registered_reference_executors():
    assert set(executors.REFERENCE_NAMES) == set(executors.names())
    for ours, theirs in executors.REFERENCE_NAMES.items():
        assert theirs in ref_executors.names(), (ours, theirs)
    assert executors.resolve("auto", device="cpu") == "torch"
    assert executors.resolve(None, device="cuda") == "cuda_fused"
    with pytest.raises(KeyError):
        executors.resolve("pallas_fused")


def test_entry_points_without_device_need_cuda(monkeypatch):
    _, port = _both(MAIN, seed=60)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc = pipeline.PipelineConfig(model=port["cfg"], volume_shape=(16, 16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run(pc, port["params"], _volume((16, 16, 16), seed=61))
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentationEngine(port["params"], pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_numpy({"w": np.zeros(3)})


@pytest.mark.parametrize(
    "change,match",
    [
        # K2 at the reduced policies serves now, in either mode (K2r's
        # plain version here): the request is served and stamped with the
        # executor and policy that ran. Sharding runs too: on a host with
        # one CPU device, two slabs lack a device, and the record says so.
        (dict(mode="subvolume", cube=8, overlap=4, executor="cuda_megakernel", precision="bf16"), None),
        (dict(shard_devices=2), "shard_geometry"),
        (dict(executor="cuda_megakernel", precision="bf16"), None),
    ],
    ids=["subvolume_k2_bf16", "shard_devices", "k2_bf16"],
)
def test_later_slices_raise(change, match):
    _, port = _both(MAIN, seed=70)
    pc = dataclasses.replace(pipeline.PipelineConfig(model=port["cfg"], volume_shape=(16, 16, 16)), **change)
    if match == "shard_geometry":
        res = pipeline.run(pc, port["params"], _volume((16, 16, 16), seed=71), device="cpu")
        assert (res.record.status, res.record.fail_type) == ("fail", "shard_geometry")
        assert res.record.executor == "sharded_torch@2" and res.segmentation is None
        return
    if match is None:
        res = pipeline.run(pc, port["params"], _volume((16, 16, 16), seed=71), device="cpu")
        assert res.record.status == "ok", res.record.fail_type
        assert (res.record.executor, res.record.precision, res.record.mode) == ("cuda_megakernel", "bf16", pc.mode)
        assert res.segmentation.shape == (16, 16, 16)
        return
    with pytest.raises(ValueError, match=match):
        pipeline.run(pc, port["params"], _volume((16, 16, 16), seed=71), device="cpu")
