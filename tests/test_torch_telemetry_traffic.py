"""The port's traffic models (``repro_torch.telemetry.traffic``) against the
reference's where the schedule is the same (the plain forward's staged
graph, the streaming layer loop, the megakernel's formula on one plan), at
every policy; the views model (K5) counted by hand; every model
batch-aware, with the weights charged once a launch; the registry's
wiring."""

import dataclasses

import pytest

from repro.core import meshnet as ref_meshnet
from repro.kernels import megakernel as ref_mk
from repro.telemetry import traffic as ref_traffic
from repro_torch.core import executors, meshnet
from repro_torch.kernels import megakernel as mk
from repro_torch.telemetry import traffic

PRECISIONS = ("fp32", "bf16", "int8w")
ODD_VOL = (10, 12, 14)
PAPER_VOL = (256, 256, 256)
MODELS = ["gwm_light", "brain_mask_fast", "atlas_104"]


def _cfgs(name, **kw):
    ref_cfg = dataclasses.replace(ref_meshnet.PAPER_MODELS[name], **kw)
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(meshnet.MeshNetConfig)}
    return ref_cfg, meshnet.MeshNetConfig(**fields)


@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", MODELS)
def test_same_schedules_price_as_the_reference(name, precision, bn):
    ref_cfg, cfg = _cfgs(name, use_batchnorm=bn)
    for vol, batch in ((ODD_VOL, 1), (PAPER_VOL, 3)):
        kw = dict(batch=batch, precision=precision)
        assert traffic.meshnet_plain_bytes(cfg, vol, **kw) == ref_traffic.meshnet_xla_bytes(ref_cfg, vol, **kw)
        assert traffic.meshnet_streaming_bytes(cfg, vol, **kw) == ref_traffic.meshnet_streaming_bytes(ref_cfg, vol, **kw)


@pytest.mark.parametrize("staging", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_megakernel_bytes_are_the_references_formula_on_one_plan(precision, staging):
    # the same segments and tiles in both packages, each role at the policy's
    # width (megakernel.py:84-104, 176-269 of the reference)
    widths = mk.plan_widths(precision, staging)
    segments = (mk.Segment(0, (1, 2), 1, 5, (5, 6, 14)), mk.Segment(2, (4,), 5, 5, (10, 4, 7)),
                mk.Segment(3, (2, 1), 5, 5, (8, 12, 14), True, 3))
    pln = mk.MegakernelPlan(segments, ODD_VOL, widths)
    ref_widths = None if precision == "fp32" else ref_mk.plan_widths(precision, int8_staging=staging)
    assert ref_widths in (None, widths)
    rpln = ref_mk.MegakernelPlan(tuple(ref_mk.Segment(**dataclasses.asdict(s)) for s in segments), ODD_VOL,
                                 ref_mk.VMEM_BUDGET, ref_widths)
    for batch in (1, 2):
        assert pln.hbm_bytes(batch) == rpln.hbm_bytes(batch=batch)
        for i, seg in enumerate(segments):
            assert pln.segment_hbm_bytes(i, batch) == ref_mk._segment_hbm_bytes(
                ref_mk.Segment(**dataclasses.asdict(seg)), pln.padded(seg), 4, ref_widths, batch=batch)


@pytest.mark.parametrize("name", MODELS)
def test_megakernel_bytes_shrink_with_the_policy(name):
    _, cfg = _cfgs(name)
    fp32, bf16, int8w = (traffic.meshnet_megakernel_bytes(cfg, PAPER_VOL, precision=p) for p in PRECISIONS)
    assert int8w < bf16 < fp32
    # the plan's own model at its widths, planned per policy
    pln = mk.plan_for_config(cfg, PAPER_VOL, precision="int8w")
    assert pln.widths == (2, 1, 1, 1) and pln.hbm_bytes() == int8w
    # without BatchNorm int8w stages bf16
    _, no_bn = _cfgs(name, use_batchnorm=False)
    assert mk.plan_for_config(no_bn, PAPER_VOL, precision="int8w").widths == (2, 1, 1, 2)


def test_views_bytes_are_hand_counted():
    _, cfg = _cfgs("gwm_light", dilations=(1, 2))
    vol = (10, 12, 14)  # 2 x 2 x 2 tiles of 8^3
    v, t = 10 * 12 * 14, 8
    layer0 = t * 27 * 512 * 1 * 4 + v * 5 * 4
    layer1 = t * 27 * 512 * 5 * 4 + v * 5 * 4
    head = v * (5 + 3) * 4
    weights = t * (27 * 1 * 5 * 4 + 15 * 4) + t * (27 * 5 * 5 * 4 + 15 * 4) + 5 * 3 * 4 + 3 * 4
    assert traffic.meshnet_views_bytes(cfg, vol) == layer0 + layer1 + head + weights
    assert traffic.meshnet_views_bytes(cfg, vol, batch=2) == 2 * (layer0 + layer1 + head) + weights


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize(
    "model",
    [traffic.meshnet_plain_bytes, traffic.meshnet_fused_bytes, traffic.meshnet_streaming_bytes,
     traffic.meshnet_views_bytes, traffic.meshnet_megakernel_bytes],
    ids=lambda f: f.__name__,
)
def test_every_model_is_batch_aware(model, precision):
    _, cfg = _cfgs("gwm_light")
    one = model(cfg, ODD_VOL, batch=1, precision=precision)
    assert one > 0
    assert model(cfg, ODD_VOL, batch=4, precision=precision) < 4 * one


def test_registry_wires_each_executor_to_its_model():
    _, cfg = _cfgs("gwm_light")
    assert set(traffic.EXECUTOR_MODELS) == set(executors.names())
    for name in executors.names():
        for precision in PRECISIONS:
            want = traffic.EXECUTOR_MODELS[name](cfg, ODD_VOL, batch=2, precision=precision)
            assert traffic.executor_hbm_bytes(name, cfg, ODD_VOL, batch=2, precision=precision) == want
            assert executors.modeled_hbm_bytes(name, cfg, ODD_VOL, batch=2, precision=precision, device="cpu") == want
    assert traffic.executor_hbm_bytes("pallas_fused", cfg, ODD_VOL) is None
