"""The slice as a whole: pipeline.run in modes full, subvolume and
streaming at fp32, bf16 and int8w, the port against the reference on the
same numpy-made weights and volumes; and the int8w Dice gate on a model
trained by the port's own trainer.

- Executor "streaming" in both packages: the same records (status,
  precision, weights' bytes, modeled device bytes), equal segmentations
  at fp32; at bf16 and int8w the logits are rounded to bf16 in each
  package from fp32 sums taken in its own order, so the argmaxes may part
  at near-ties: at least 99 % of voxels agree.
- Executors "torch", "cuda_fused" and "cuda_megakernel" (their kernels'
  plain versions here) against the reference's "xla": equal segmentations
  at fp32, at least 99 % of voxels at bf16 and int8w.
- The Dice gate (tests/test_precision.py:170-217; core/executors.py
  ``int8w``): on a briefly trained model, the int8w and bf16 Dice at least
  0.99 of the fp32 Dice, for the executors torch, cuda_fused, streaming
  and cuda_megakernel (at its own plan and at a forced plan of multi-layer
  segments).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.core import pipeline as ref_pipeline
from repro_torch import bridge
from repro_torch.core import executors, meshnet, pipeline
from repro_torch.data import mri
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops
from repro_torch.telemetry import traffic
from repro_torch.training import losses, trainer

SMALL = dict(dilations=(1, 2, 4))
KW = dict(volume_shape=(16, 16, 16), cube=8, overlap=4, min_component_size=4)


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


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("mode", ["full", "subvolume", "streaming"])
def test_pipeline_modes_and_policies_match_reference(mode, precision):
    ref_cfg, cfg = ref_meshnet.MeshNetConfig(**SMALL), meshnet.MeshNetConfig(**SMALL)
    tree = _np_params(cfg, seed=1)
    ref_params, params = jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, "cpu")
    vol = _volume((14, 16, 12), seed=2)  # non-cubic: conform resamples
    kw = dict(KW, mode=mode, precision=precision)

    def ref_run(executor):
        return ref_pipeline.run(ref_pipeline.PipelineConfig(model=ref_cfg, executor=executor, **kw), ref_params, jnp.asarray(vol))

    def run(executor):
        return pipeline.run(pipeline.PipelineConfig(model=cfg, executor=executor, **kw), params, vol, device="cpu")

    expect, got = ref_run("streaming"), run("streaming")
    for res in (expect, got):
        assert res.record.status == "ok", res.record.fail_type
    assert got.record.mode == expect.record.mode == mode
    assert got.record.executor == expect.record.executor == "streaming"
    assert got.record.precision == expect.record.precision == precision
    assert got.record.params_bytes == expect.record.params_bytes
    assert got.record.hbm_bytes_modeled == expect.record.hbm_bytes_modeled
    seg, ref_seg = got.segmentation.numpy(), np.asarray(expect.segmentation)
    assert seg.dtype == np.int32 and seg.shape == (16, 16, 16)
    if precision == "fp32":
        np.testing.assert_array_equal(seg, ref_seg)
    else:
        assert np.mean(seg == ref_seg) >= 0.99
    oracle = ref_run("xla")
    assert executors.REFERENCE_NAMES[run("torch").record.executor] == oracle.record.executor == "xla"
    for executor in ("torch", "cuda_fused", "cuda_megakernel"):
        res = run(executor)
        assert res.record.status == "ok" and res.record.precision == precision
        assert res.record.executor == executor and res.record.mode == mode
        assert res.record.params_bytes == expect.record.params_bytes
        if precision == "fp32":
            np.testing.assert_array_equal(res.segmentation.numpy(), np.asarray(oracle.segmentation))
        else:
            # K2r's int8 staging rounds where the oracle does not: the
            # reference's bar for staged argmaxes on untrained weights is
            # 0.95 (tests/test_precision.py:127-135)
            bar = 0.95 if (executor, precision) == ("cuda_megakernel", "int8w") else 0.99
            assert np.mean(res.segmentation.numpy() == np.asarray(oracle.segmentation)) >= bar, executor
    if mode == "subvolume":  # the cube's model times the cubes
        per_cube = executors.modeled_hbm_bytes("cuda_fused", cfg, (16, 16, 16), precision=precision, device="cpu")
        assert run("cuda_fused").record.hbm_bytes_modeled == 8 * per_cube


def test_megakernel_at_a_reduced_policy_names_the_k2_slice():
    # cuda_megakernel serves every policy (K2r at bf16 and int8w), stamped
    # with the policy, the weights' bytes and the plan's bytes at its widths
    cfg = meshnet.MeshNetConfig(**SMALL)
    params = bridge.params_from_numpy(_np_params(cfg, seed=3), "cpu")
    vol = _volume((16, 16, 16), seed=4)
    for precision in ("fp32", "bf16", "int8w"):
        pc = pipeline.PipelineConfig(model=cfg, executor="cuda_megakernel", precision=precision, **KW)
        res = pipeline.run(pc, params, vol, device="cpu")
        assert res.record.status == "ok" and res.record.executor == "cuda_megakernel"
        assert res.record.precision == precision
        assert res.record.hbm_bytes_modeled == traffic.meshnet_megakernel_bytes(cfg, (16, 16, 16), precision=precision)
        plain = pipeline.run(dataclasses.replace(pc, executor="torch"), params, vol, device="cpu")
        bar = 0.95 if precision == "int8w" else 0.99  # int8 staging (tests/test_precision.py:127-135)
        assert np.mean(res.segmentation.numpy() == plain.segmentation.numpy()) >= bar


@pytest.fixture(scope="module")
def trained_gwm():
    """A briefly trained gwm-style model from the port's own trainer, the
    recipe of the reference's ``trained_gwm`` fixture
    (tests/test_precision.py:170-190): real decision margins make the Dice
    gate meaningful (random-init logits are coin flips at every policy)."""
    cfg = trainer.TrainConfig(
        model=meshnet.MeshNetConfig(channels=5, dropout_rate=0.0),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(24, 24, 24)), batch_size=2),
        steps=40,
        eval_subjects=1,
        log_every=1000,
        seed=1,
    )
    res = trainer.train(cfg, verbose=False, device="cpu")
    vol, labels = mri.generate(torch.Generator().manual_seed(10_000), mri.SyntheticMRIConfig(shape=(24, 24, 24)), device="cpu")
    return res.params, cfg.model, vol, labels


def test_int8w_dice_gate_every_backend(trained_gwm):
    params, cfg, vol, labels = trained_gwm
    x = vol[None]
    ref_seg = executors.apply("torch", params, x, cfg).argmax(-1)[0]
    d_ref = float(losses.dice_score(ref_seg.to(torch.int32), labels, cfg.num_classes))
    assert d_ref > 0.4, f"training failed to produce a usable model: {d_ref}"
    for backend in ("torch", "cuda_fused", "streaming", "cuda_megakernel"):
        for precision in ("bf16", "int8w"):
            seg = executors.apply(backend, params, x, cfg, precision=precision).float().argmax(-1)[0]
            d = float(losses.dice_score(seg.to(torch.int32), labels, cfg.num_classes))
            assert d >= 0.99 * d_ref, (backend, precision, d, d_ref)
    # cuda_megakernel at int8w on a forced plan of multi-layer segments (the
    # port's own plan stages int8 after every layer): three segments, two
    # int8 staging arrays (tests/test_precision.py::TestInt8wDiceGate::
    # test_dice_ratio_with_forced_int8_staging)
    vol = tuple(x.shape[1:4])
    forced = mk.MegakernelPlan(
        (mk.Segment(0, (1, 2, 4), 1, 5, (12, 12, 24)), mk.Segment(3, (8, 16), 5, 5, (24, 8, 24)),
         mk.Segment(5, (8, 4, 2, 1), 5, 5, (24, 24, 12), True, cfg.num_classes)),
        vol, mk.plan_widths("int8w", True),
    )
    before = mk.reduced_launches
    seg = ops.meshnet_apply_megakernel(params, x, cfg, pln=forced, precision="int8w").float().argmax(-1)[0]
    assert mk.reduced_launches == before  # the CPU path launches nothing
    d = float(losses.dice_score(seg.to(torch.int32), labels, cfg.num_classes))
    assert d >= 0.99 * d_ref, ("forced plan", d, d_ref)
