"""K2z's plain version: the megakernel forward with ``z_bounds``
(``ops.meshnet_apply_megakernel(..., z_bounds=(z_lo, z_hi))``, K2's and
K2r's plain version ``ref.megakernel_segment`` with the bounds) on the CPU,
on inputs made with numpy:

- against the reference's Pallas megakernel with its dynamic ``z_bounds``
  in interpret mode (one small window, dilations (1, 2), perturbed params,
  values outside the bounds non-zero), within 1e-4 at fp32, and at bf16
  within one bf16 step of the largest logit;
- against a per-layer masking oracle (the plain conv over the window, the
  rows outside the valid interval zeroed on the input and after every
  layer but the last) for several bounds: inside, clipped at either end,
  wider than the window, empty, on one- and several-segment plans;
- ``z_bounds`` of the whole volume leaving the forward as it is, and the
  geometry array carrying the valid interval ahead of the dilations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.core import meshnet, spatial_shard
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops, quantize, ref

WINDOW = (1, 8, 7, 6)
SMALL = (1, 2)
BF16_STEP = 2.0**-8


def _np_params(cfg, seed):
    """Weights and non-zero biases and BatchNorm statistics, made with
    numpy, so zeros outside the bounds do not stay zero by themselves."""
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


def _both(dilations, seed, **kw):
    cfg = meshnet.MeshNetConfig(dilations=dilations, **kw)
    ref_cfg = ref_meshnet.MeshNetConfig(dilations=dilations, **kw)
    params = _np_params(cfg, seed)
    return cfg, ref_cfg, params, bridge.params_from_numpy(params, "cpu")


def _window(seed, shape=WINDOW):
    """A window whose every row, inside the bounds or not, is non-zero."""
    return (0.5 + np.random.default_rng(seed).random(shape)).astype(np.float32)


def _oracle(params, x, cfg, bounds):
    """The masked per-layer forward: the input's rows outside the valid
    interval zeroed, each layer the plain 'same' conv over the whole
    window, BatchNorm and ReLU, its rows outside zeroed but after the
    last layer, then the head."""
    lo, hi = ref.z_interval(x.shape[1], bounds)
    keep = torch.zeros(x.shape[1], dtype=torch.bool)
    keep[lo:hi] = True
    keep = keep.view(1, -1, 1, 1, 1)
    a = torch.where(keep, x[..., None], 0.0)
    for i, d in enumerate(cfg.dilations):
        a, _ = meshnet.apply_layer(params["layers"][i], a, d, cfg)
        if i + 1 < len(cfg.dilations):
            a = torch.where(keep, a, 0.0)
    head = params["head"]
    return torch.einsum("bdhwi,io->bdhwo", a, head["w"][0, 0, 0]) + head["b"]


def test_plain_zbounds_matches_pallas_zbounds_interpret():
    """The reference's Pallas megakernel with a dynamic (2,) int32 z_bounds
    in interpret mode on the same window: a bound inside it at each end,
    so both masks (the staged input's and every layer's) hold."""
    cfg, ref_cfg, params, port = _both(SMALL, seed=1)
    x = _window(2)
    bounds = (2, 6)
    got = ops.meshnet_apply_megakernel(port, torch.from_numpy(x), cfg, z_bounds=bounds)
    expect = np.asarray(ref_ops.meshnet_apply_megakernel(
        params, jnp.asarray(x), ref_cfg, z_bounds=jnp.array(bounds, jnp.int32), interpret=True
    ))
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-4, rtol=0)
    # the bounds are load-bearing: without them the logits differ
    unbounded = ops.meshnet_apply_megakernel(port, torch.from_numpy(x), cfg)
    assert float((unbounded - got).abs().max()) > 1e-2


def test_plain_zbounds_bf16_matches_pallas_zbounds_interpret():
    """K2r-z's plain version against the reference's reduced megakernel
    with z_bounds (its ping/pong at bf16: a round a layer, as K2r's),
    within one bf16 step of the largest logit."""
    cfg, ref_cfg, params, port = _both(SMALL, seed=3)
    x = _window(4)
    bounds = (-2, 5)
    got = ops.meshnet_apply_megakernel(port, torch.from_numpy(x), cfg, z_bounds=bounds, precision="bf16")
    expect = np.asarray(ref_ops.meshnet_apply_megakernel(
        params, jnp.asarray(x), ref_cfg, z_bounds=jnp.array(bounds, jnp.int32), interpret=True, precision="bf16"
    )).astype(np.float32)
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.float().numpy() - expect)) <= BF16_STEP * np.max(np.abs(expect))


@pytest.mark.parametrize(
    "bounds",
    [(2, 6), (0, 8), (-3, 5), (3, 20), (-10, 30), (5, 5), (6, 2), (9, 12), (-4, -1)],
    ids=["inside", "whole", "clipped_low", "clipped_high", "wider", "empty", "inverted", "past_the_end", "before"],
)
@pytest.mark.parametrize("plan", ["planner", "several_segments", "multi_layer"])
def test_plain_zbounds_against_per_layer_masking(bounds, plan):
    """The planner's plans are one layer a segment here, so only the
    staged input's mask acts; the forced plans of 2 + 1 and 3 layers a
    segment reach the per-layer mask inside a segment too."""
    cfg, _, _, port = _both((1, 2, 1), seed=5)
    x = torch.from_numpy(_window(6, (2, 8, 7, 6)))
    vol = tuple(x.shape[1:4])
    if plan == "planner":
        pln = mk.plan_for_config(cfg, vol, batch=2)
    elif plan == "several_segments":
        pln = mk.MegakernelPlan((mk.Segment(0, (1, 2), 1, 5, (4, 4, 4)), mk.Segment(2, (1,), 5, 5, (4, 4, 4), True, 3)), vol)
    else:
        pln = mk.MegakernelPlan((mk.Segment(0, (1, 2, 1), 1, 5, (2, 4, 3), True, 3),), vol)
    got = ops.meshnet_apply_megakernel(port, x, cfg, pln=pln, z_bounds=bounds)
    expect = _oracle(port, x, cfg, bounds)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
def test_whole_volume_bounds_change_nothing(precision):
    """z_bounds covering the volume (or wider) is the forward without
    them, bit for bit, at every policy."""
    cfg, _, _, port = _both((1, 2, 1), seed=7)
    x = torch.from_numpy(_window(8))
    plain = ops.meshnet_apply_megakernel(port, x, cfg, precision=precision)
    for bounds in [(0, 8), (-5, 50)]:
        got = ops.meshnet_apply_megakernel(port, x, cfg, precision=precision, z_bounds=bounds)
        assert torch.equal(got, plain), bounds


@pytest.mark.parametrize("precision", ["bf16", "int8w"])
def test_reduced_segments_mask_the_staged_input(precision):
    """K2r-z's plain version segment by segment on a reduced plan: junk on
    the input's rows outside the bounds (NaN at bf16, codes at int8) never
    reaches the output, which equals the segment on a zeroed input."""
    cfg, _, _, port = _both((1, 2), seed=9)
    prepared = quantize.prepare_params(port, cfg, precision)
    pln = mk.plan_for_config(cfg, WINDOW[1:], precision=precision)
    seg = pln.segments[0]
    layers, head = ops.megakernel_operands(prepared, cfg, seg, precision)
    h = seg.halo
    dtype = torch.int8 if precision == "int8w" else torch.bfloat16
    x = torch.zeros((1,) + tuple(p + 2 * h for p in pln.padded(seg)) + (1,), dtype=dtype)
    inside = (slice(None), slice(h + 3, h + 6), slice(h, h + 7), slice(h, h + 6))
    x[inside] = 5
    junk = x.clone()
    junk[:, h : h + 3, h : h + 7, h : h + 6] = 100 if dtype == torch.int8 else float("nan")
    junk[:, h + 6 : h + 8, h : h + 7, h : h + 6] = -100 if dtype == torch.int8 else float("inf")
    deq, qs = mk.scale_operands(pln, 0)
    assert not deq
    scales = quantize.staging_scales_from_bn(prepared, cfg) if precision == "int8w" else None
    q = scales[len(seg.dilations) - 1] if qs else None
    got = mk.run_segment(junk, pln, 0, layers, head, None, q, z_bounds=(3, 6))
    expect = mk.run_segment(x, pln, 0, layers, head, None, q, z_bounds=(3, 6))
    o = pln.out_halo(0)
    w = (slice(None),) + tuple(slice(o, o + p) for p in pln.padded(seg))
    assert torch.equal(got[w], expect[w])


def test_geometry_carries_the_valid_interval():
    cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
    pln = mk.plan_for_config(cfg, (10, 12, 14))
    seg = pln.segments[0]
    shape = (1,) + tuple(p + 2 * seg.halo for p in pln.padded(seg))
    plain = mk.geometry(shape, pln, 0)
    k = len(seg.dilations)
    padded = pln.padded(seg)[0]
    # 27 ints ahead of the dilations: the valid interval, then the band of
    # output rows written (all of the tile-padded region without one)
    assert len(plain) == 27 + k and plain[-k:] == list(seg.dilations)
    assert plain[23:27] == [0, 10, 0, padded]
    for bounds, want in [((3, 7), [3, 7]), ((-4, 99), [0, 10]), ((8, 2), [8, 8]), ((12, 20), [10, 10])]:
        g = mk.geometry(shape, pln, 0, bounds)
        assert g[23:25] == want, bounds
        assert g[:23] == plain[:23] and g[25:] == plain[25:]
    for band, want in [((2, 9), [2, 9]), ((-3, 99), [0, padded]), ((7, 3), [7, 7])]:
        g = mk.geometry(shape, pln, 0, (3, 7), band)
        assert g[23:27] == [3, 7] + want, band
        assert g[:23] == plain[:23] and g[27:] == plain[27:]


def test_wrapper_rejects_malformed_bounds():
    cfg, _, _, port = _both((1,), seed=11)
    x = torch.from_numpy(_window(12))
    with pytest.raises(ValueError, match="z_bounds"):
        ops.meshnet_apply_megakernel(port, x, cfg, z_bounds=(1, 2, 3))


def test_zbounds_do_not_touch_the_launch_counts():
    """On the CPU no count moves, with or without bounds."""
    cfg, _, _, port = _both((1, 2), seed=13)
    before = (mk.launches, mk.reduced_launches, mk.z_launches)
    ops.meshnet_apply_megakernel(port, torch.from_numpy(_window(14)), cfg, z_bounds=(1, 5))
    assert (mk.launches, mk.reduced_launches, mk.z_launches) == before


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
def test_banded_plain_path_reads_only_its_band(precision):
    """Each segment with a band (``megakernel.segment_bands`` of the kept
    rows) on a staging array whose rows outside the band it may read are
    poison (NaN, or the code 100 at int8): its band's rows are bit-equal to
    the unbanded segment's on the clean array; and the banded forward's
    kept rows equal the unbanded forward's, bit for bit."""
    cfg, _, _, port = _both((1, 2, 1), seed=17)
    x = torch.from_numpy(_window(18, (1, 14, 7, 6)))
    bounds, rows = (2, 13), (5, 9)
    pln = mk.MegakernelPlan((mk.Segment(0, (1,), 1, 5, (4, 4, 4)), mk.Segment(1, (2, 1), 5, 5, (3, 4, 4), True, 3)),
                            (14, 7, 6), mk.plan_widths(precision))
    prepared = quantize.prepare_params(port, cfg, precision) if precision != "fp32" else port
    scales = quantize.staging_scales_from_bn(prepared, cfg) if precision == "int8w" else None
    whole = ops.meshnet_apply_megakernel(prepared, x, cfg, pln=pln, precision=precision, z_bounds=bounds)
    banded = ops.meshnet_apply_megakernel(prepared, x, cfg, pln=pln, precision=precision, z_bounds=bounds, rows=rows)
    assert torch.equal(banded[:, rows[0] : rows[1]], whole[:, rows[0] : rows[1]])
    bands = mk.segment_bands(pln, rows, bounds)
    assert bands == [(2, 12), (5, 9)]  # the kept rows grown by the 3 rows of dilation after segment 0
    xs = {"fp32": x.float(), "bf16": x.to(torch.bfloat16), "int8w": quantize.quantize_input(x)}[precision][..., None]
    h = pln.segments[0].halo
    act = torch.zeros((1,) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (1,), dtype=xs.dtype)
    act[:, h : h + 14, h : h + 7, h : h + 6] = xs
    junk = 100 if xs.dtype == torch.int8 else float("nan")
    for i, seg in enumerate(pln.segments):
        layers, head = ops.megakernel_operands(prepared, cfg, seg, precision)
        deq, qs = mk.scale_operands(pln, i) if precision != "fp32" else (False, False)
        operands = (layers, head, scales[seg.start - 1] if deq else None,
                    scales[seg.start + len(seg.dilations) - 1] if qs else None)
        clean = mk.run_segment(act, pln, i, *operands, z_bounds=bounds)
        lo, hi = bands[i]
        poisoned = act.clone()
        poisoned[:, : seg.halo + lo - seg.halo] = junk  # rows below the band's reach
        poisoned[:, seg.halo + hi + seg.halo :] = junk  # and above it
        got = mk.run_segment(poisoned, pln, i, *operands, z_bounds=bounds, band=bands[i])
        o, padded = pln.out_halo(i), pln.padded(seg)
        kept = (slice(None), slice(o + lo, o + hi), slice(o, o + padded[1]), slice(o, o + padded[2]))
        assert torch.equal(got[kept], clean[kept]), i
        act = clean


def test_band_rows_layers_of_the_sharded_windows():
    """gwm_light's 4 slabs of 64 rows at 256^3: each window of 64 + 2 x 46
    rows computes 9 one-layer segments; the bands the kept rows need are
    64 + 2 R_j rows at an inner slab and 64 + R_j at an end slab (R_j = 45,
    43, 39, 31, 15, 7, 3, 1, 0), 3,408 rows x layers in all against 5,616
    without them, at fp32 and bf16 alike."""
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    radius = sum(cfg.dilations)
    for precision in ("fp32", "bf16"):
        pln = mk.plan_for_config(cfg, (64 + 2 * radius, 256, 256), precision=precision)
        assert [len(seg.dilations) for seg in pln.segments] == [1] * 9
        total = 0
        for i in range(4):
            bands = mk.segment_bands(pln, (radius, radius + 64), spatial_shard.window_z_bounds(i, 64, 4, radius))
            total += mk.band_rows_layers(pln, bands)
        assert total == 3408
        assert 4 * (64 + 2 * radius) * 9 == 5616 <= 4 * mk.band_rows_layers(pln)
