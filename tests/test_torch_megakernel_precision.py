"""The megakernel at the bf16 and int8w policies (K2r's plain version and
planner, ``ops.meshnet_apply_megakernel(precision=...)``) against the
reference on the CPU, on inputs made with numpy:

- the int8 staging scales and codes: ``staging_scales_from_bn`` within
  1e-6 relative, ``calibrate`` within 1e-5 (its probe forward sums in
  another order) and bit-equal from the same activations,
  ``quantize_staging``'s codes equal;
- the planner's per-role widths, K2r's shared-memory layout, and the DP at
  reduced widths (int8 staging only at the reference plan's boundaries);
- the plain version segment by segment against the reference's Pallas
  ``_run_segment`` in interpret mode on a forced 3-segment plan, the
  reference's staging arrays feeding both: int8 codes within +-1 and equal
  at >= 99.9 % of written voxels, bf16 within one bf16 step (2^-8) of the
  array's largest magnitude; at int8w with int8 staging, at bf16, and at
  int8w without BatchNorm (bf16 staging);
- whole forwards against the reference's gates (tests/test_precision.py):
  bf16 bit-equal to the port's plain reduced forward, within 1e-3 of the
  reference's ``xla`` bf16 oracle (one bf16 step of the largest logit
  where logits pass 0.25) and 1e-2 of fp32; int8w within 2e-2 of the oracle on a plan with no staging (the
  reference's own plan at this shape is one segment) and within 8e-2, argmax
  agreeing with fp32 on >= 95 % of voxels, where forced plans stage int8 at
  every boundary (a segment a layer; multi-layer segments); gwm_light's own
  int8w plan at 32^3, int8 at the reference plan's two boundaries (those
  of 256^3), within 2e-2 of the reference's ``pallas_megakernel`` (fault
  F2); no BatchNorm within 2e-2 and 3e-2
  of fp32 at bf16; calibrated scales no worse than the BatchNorm bound.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import executors as ref_executors
from repro.core import meshnet as ref_meshnet
from repro.kernels import megakernel as ref_mk
from repro.kernels import quantize as ref_quantize
from repro_torch import bridge
from repro_torch.core import executors, meshnet
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops, quantize

ODD_SHAPE = (1, 10, 12, 14)
VOL = ODD_SHAPE[1:]
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


def _np_params(cfg, seed, init_like=False):
    """Weights made with numpy: He-normal conv and head weights; with
    ``init_like`` the zero biases and identity BatchNorm of
    ``meshnet.init`` (the weights the reference's precision gates are
    stated on), else non-trivial biases and BatchNorm statistics."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    layers, cin, c = [], cfg.in_channels, cfg.channels
    for _ in cfg.dilations:
        w = (rng.standard_normal((3, 3, 3, cin, c)) * np.sqrt(2.0 / (27 * cin))).astype(f32)
        if init_like:
            layer = {"w": w, "b": np.zeros(c, f32)}
            bn = dict(bn_scale=np.ones(c, f32), bn_bias=np.zeros(c, f32), bn_mean=np.zeros(c, f32), bn_var=np.ones(c, f32))
        else:
            layer = {"w": w, "b": (0.1 * rng.standard_normal(c)).astype(f32)}
            bn = dict(
                bn_scale=(1.0 + 0.2 * rng.standard_normal(c)).astype(f32),
                bn_bias=(0.1 * rng.standard_normal(c)).astype(f32),
                bn_mean=(0.3 * rng.standard_normal(c)).astype(f32),
                bn_var=(0.5 + rng.random(c)).astype(f32),
            )
        if cfg.use_batchnorm:
            layer.update(bn)
        layers.append(layer)
        cin = c
    head = {
        "w": (rng.standard_normal((1, 1, 1, c, cfg.num_classes)) * np.sqrt(2.0 / c)).astype(f32),
        "b": np.zeros(cfg.num_classes, f32) if init_like else (0.1 * rng.standard_normal(cfg.num_classes)).astype(f32),
    }
    return {"layers": layers, "head": head}


def _volume(shape, seed):
    """A conformed-like [0, 1] volume: a noisy bright ellipsoid on a dark
    field, scaled to its largest value."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((zz / 0.6) ** 2 + (yy / 0.8) ** 2 + (xx / 0.7) ** 2)
    vol = np.maximum(np.where(r < 1.0, 120.0 - 60.0 * r, 5.0) + 8.0 * rng.standard_normal(shape), 0.0)
    return (vol / vol.max()).astype(np.float32)[None]


def _port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(meshnet.MeshNetConfig)}
    return meshnet.MeshNetConfig(**fields)


def _t(a) -> torch.Tensor:
    """A numpy (or reference) array as a CPU tensor, bf16 bit-equal."""
    return bridge.params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _written(pln, i):
    o = pln.out_halo(i)
    return (slice(None),) + tuple(slice(o, o + p) for p in pln.padded(pln.segments[i])) + (slice(None),)


# ------------------------------------------------------- staging scales ---


@pytest.mark.parametrize("bn", [True, False])
def test_staging_scales_from_bn_match_reference(bn):
    ref_cfg = ref_meshnet.MeshNetConfig(use_batchnorm=bn, **SMALL)
    tree = _np_params(ref_cfg, seed=1)
    ref_params = ref_quantize.prepare_params(jax.tree.map(jnp.asarray, tree), ref_cfg, "int8w")
    params = quantize.prepare_params(bridge.params_from_numpy(tree, "cpu"), _port_cfg(ref_cfg), "int8w")
    expect = ref_quantize.staging_scales_from_bn(ref_params, ref_cfg)
    got = quantize.staging_scales_from_bn(params, _port_cfg(ref_cfg))
    assert quantize.BN_BOUND_SIGMA == ref_quantize.BN_BOUND_SIGMA
    if not bn:
        assert got is None and expect is None
        return
    assert len(got) == len(expect) == len(ref_cfg.dilations)
    for g, e in zip(got, expect):
        assert g.dtype == torch.float32 and g.shape == (ref_cfg.channels,)
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6, atol=0)


def test_calibrate_matches_reference():
    # The probe forwards sum in another order (the plain conv against XLA's),
    # so the observed maxima, three fp32 layers deep, part by a few ulp: the
    # scales within 1e-5 relative (the fp32 forward's parity). From the same
    # activations the port's scales are the reference's formula, bit for bit.
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    cfg = _port_cfg(ref_cfg)
    tree = _np_params(ref_cfg, seed=2)
    x = _volume(VOL, seed=3)
    params = bridge.params_from_numpy(tree, "cpu")
    expect = ref_quantize.calibrate(jax.tree.map(jnp.asarray, tree), ref_cfg, jnp.asarray(x))
    got = quantize.calibrate(params, cfg, torch.from_numpy(x))
    act = torch.from_numpy(x)[..., None]
    for i, (g, e) in enumerate(zip(got, expect, strict=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5, atol=0)
        act, _ = meshnet.apply_layer(params["layers"][i], act, cfg.dilations[i], cfg)
        amax = jnp.max(jnp.abs(jnp.asarray(act.numpy())), axis=(0, 1, 2, 3))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jnp.maximum(amax * 1.25, 1e-6) / 127.0))


def test_quantize_staging_is_bit_equal():
    rng = np.random.default_rng(4)
    scale = (0.01 + rng.random(5)).astype(np.float32)
    x = np.maximum(rng.standard_normal((3, 7, 6, 5)) * 60 * scale, 0).astype(np.float32)
    x[0, 0, 0] = (np.arange(5) + 0.5) * scale  # halves: ties round to even
    x[0, 0, 1] = 300 * scale  # saturates at 127
    expect = np.asarray(ref_quantize.quantize_staging(jnp.asarray(x), jnp.asarray(scale)))
    got = quantize.quantize_staging(torch.from_numpy(x), torch.from_numpy(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), expect)
    # a bf16 input widens exactly first
    xb = x.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(
        quantize.quantize_staging(_t(xb), torch.from_numpy(scale)).numpy(),
        np.asarray(ref_quantize.quantize_staging(jnp.asarray(xb), jnp.asarray(scale))),
    )


# ---------------------------------------------------------------- planner ---


@pytest.mark.parametrize("staging", [None, True, False])
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
def test_plan_widths_are_the_references(precision, staging):
    expect = ref_mk.plan_widths(precision, int8_staging=staging)
    assert mk.plan_widths(precision, staging) == expect


def test_reduced_layout_is_hand_counted():
    # K2r (csrc/megakernel_lp.cu): 16 zero bytes; per layer its bf16 B
    # fragments (9 tap rows x k16 steps x n8 tiles x 256 bytes; cin 1 or 5
    # is one group of 8 channels, 3 x taps -> 2 k16 steps), its A-offset
    # table (8 bytes a step -> 16) and bias, scale, offset (15 floats -> 64
    # bytes); the head's fragments (1 k16 step x 1 n8 tile) and bias (12 ->
    # 16 bytes); deq (4 -> 16) and qscale (20 -> 32)
    seg = mk.Segment(0, (1, 2), 1, 5, (4, 4, 8), True, 3)
    layer = 9 * 2 * 1 * 256 + 16 + 64
    params = 16 + 2 * layer + 256 + 16 + 16 + 32
    # layer 0's output (the tile grown by 2 a side) in the A layout, 16 bytes a position
    ping = (4 + 4) * (4 + 4) * (8 + 4) * 16
    # a warp's ring: 3 packed spans of the first layer's 12 + 2 x 1 positions
    # of one channel (28 -> 32 bytes, + 32), its A buffer (14 positions of
    # 16 bytes) and the head's row buffer (8 voxels x 3 bf16 logits, 48 + 16)
    ring = 4 * (3 * (32 + 32) + 14 * 16 + 64)
    for precision in ("bf16", "int8w"):
        widths = mk.plan_widths(precision)
        assert mk._smem_layout(seg, widths) == (params // 4, ping // 4, 0, ring // 4)
        assert mk._segment_smem_bytes(seg, widths) == params + ping + ring == 23_920
    assert mk._smem_layout(seg) == (27 * 1 * 8 + 16 + 27 * 5 * 8 + 16 + 20, (4 + 4) * (4 + 4) * (8 + 4) * 5, 0,
                                    4 * 2 * (16 + 4))  # K2's, fp32
    # three 21 -> 21 layers: 3 groups a position (48 bytes), 5 k16 steps, 3 n8
    # tiles; 63 vector floats -> 256 bytes, scales 84 -> 96 each; layer 0's
    # output 6^3 and layer 1's 4^3 positions; bf16 staging of several
    # channels copied straight into the A layout: slots of 6 + 2 positions
    wide = mk.Segment(3, (1, 1, 1), 21, 21, (2, 2, 2))
    layer = 9 * 5 * 3 * 256 + 48 + 256
    assert mk._smem_layout(wide, (2, 2, 2, 2)) == ((16 + 3 * layer + 2 * 96) // 4, 6**3 * 48 // 4, 4**3 * 48 // 4,
                                                   4 * 3 * 8 * 48 // 4)
    # from int8 staging: the first layer's fragments twice (hi and lo of the
    # dequantised weights), packed spans (8 x 21 -> 336 bytes, + 32) laid out
    # in an A buffer, and the int8 output's row buffer (2 x 21 x 2 -> 96, + 16)
    assert mk._smem_layout(wide, (2, 1, 1, 1)) == ((16 + 3 * layer + 9 * 5 * 3 * 256 + 2 * 96) // 4, 6**3 * 48 // 4,
                                                   4**3 * 48 // 4, 4 * (3 * 368 + 8 * 48 + 112) // 4)


@pytest.mark.parametrize("precision,staging", [("bf16", None), ("int8w", True), ("int8w", False)])
def test_reduced_plans_price_their_widths(precision, staging):
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    widths = mk.plan_widths(precision, staging)
    for vol, budget in (((256,) * 3, mk.SMEM_BUDGET), (VOL, 20_000)):
        pln = mk.plan_for_config(cfg, vol, smem_budget=budget, precision=precision, int8_staging=staging)
        assert pln.widths == widths
        # int8 staging: int8 at the reference plan's boundaries, bf16 at the others
        assert (pln.int8_at is not None) == (widths[3] == 1)
        dtype = {4: torch.float32, 2: torch.bfloat16, 1: torch.int8}
        for i, seg in enumerate(pln.segments):
            assert mk._segment_smem_bytes(seg, widths) <= budget
            x_dtype, out_dtype = pln.dtypes(i)
            stage_in, stage_out = pln.stage(i)
            assert x_dtype == dtype[widths[2] if i == 0 else widths[3] if stage_in else widths[0]]
            assert out_dtype == (torch.bfloat16 if seg.fuse_head else dtype[widths[3] if stage_out else widths[0]])
            assert i == 0 or stage_in == pln.stage(i - 1)[1]
        assert pln.modeled_ms() == pytest.approx(
            float(mk._input_pad_ms(pln.segments[0], vol, 1, widths))
            + sum(pln.segment_modeled_ms(i) for i in range(len(pln.segments))))


@pytest.mark.parametrize("int8_staging", [True, False])
def test_reduced_dp_is_the_minimum_of_an_exhaustive_search(int8_staging):
    """Over every split and tile, the least modeled time. With int8 staging
    the splits are those that cut where the reference's plan does (forced
    here to layer 2; its own plan at this shape is one segment, so the
    planner's has no cut), each boundary priced at its own width: int8 at
    the cut, bf16 at the others."""
    cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
    widths = mk.plan_widths("int8w", int8_staging)
    n, budget = 3, 30_000
    cut = frozenset({2}) if int8_staging else None
    tiles = list(itertools.product(*[mk._axis_candidates(v) for v in VOL]))
    best = float("inf")
    for cuts in itertools.chain.from_iterable(itertools.combinations(range(1, n), r) for r in range(n)):
        if cut is not None and not cut <= set(cuts):
            continue
        bounds = (0,) + cuts + (n,)
        total = 0
        for i, j in zip(bounds, bounds[1:]):
            stage = mk.STAGED if cut is None else (i in cut, j in cut)
            costs = []
            for tile in tiles:
                seg = mk.Segment(i, cfg.dilations[i:j], 1 if i == 0 else 5, 5, tile, j == n, 3)
                if mk._segment_smem_bytes(seg, widths) <= budget:
                    c = float(mk._segment_modeled_ms(seg, VOL, 1, widths, stage))
                    costs.append(c + (float(mk._input_pad_ms(seg, VOL, 1, widths)) if i == 0 else 0.0))
            total += min(costs, default=float("inf"))
        best = min(best, total)
    _, segments = mk._dp(cfg.dilations, 1, 5, 3, VOL, budget, 1, widths, cut)
    pln = mk.MegakernelPlan(segments, VOL, widths, cut)
    assert pln.modeled_ms() == pytest.approx(best, rel=1e-12)
    assert pln.crossings == (1 if int8_staging else 0)
    own = mk.plan_for_config(cfg, VOL, smem_budget=budget, precision="int8w", int8_staging=int8_staging)
    assert own.crossings == 0 and own.int8_at == (frozenset() if int8_staging else None)
    assert own.modeled_ms() <= pln.modeled_ms() * (1 + 1e-12)


# ----------------------------------------- K2r's plain version, segments ---


def _forced_plan(widths):
    """A 3-segment plan at (10, 12, 14) over dilations (1, 2, 4, 2, 1): a
    two-layer first segment, a one-layer middle one of 2 x 3 tiles, a
    two-layer last one fusing the head."""
    return mk.MegakernelPlan(
        (mk.Segment(0, (1, 2), 1, 5, VOL), mk.Segment(2, (4,), 5, 5, (10, 6, 7)),
         mk.Segment(3, (2, 1), 5, 5, (5, 12, 14), True, 3)),
        VOL, widths,
    )


@pytest.mark.parametrize(
    "precision,bn", [("int8w", True), ("bf16", True), ("int8w", False)], ids=["int8w_staging", "bf16", "int8w_no_bn"]
)
def test_segments_against_pallas_megakernel_interpret(precision, bn):
    # The TPU kernel itself, segment by segment in interpret mode, at the
    # policy (layer_epilogue, compute_dtype bf16, staging_scales); each
    # staging array's written region held to K2r's plain version.
    ref_cfg = ref_meshnet.MeshNetConfig(dilations=(1, 2, 4, 2, 1), use_batchnorm=bn)
    cfg = _port_cfg(ref_cfg)
    tree = _np_params(ref_cfg, seed=7)
    x = _volume(VOL, seed=8)[..., None]
    ref_params = ref_quantize.prepare_params(jax.tree.map(jnp.asarray, tree), ref_cfg, precision)
    params = quantize.prepare_params(bridge.params_from_numpy(tree, "cpu"), cfg, precision)
    ref_scales = ref_quantize.staging_scales_from_bn(ref_params, ref_cfg) if precision == "int8w" else None
    scales = quantize.staging_scales_from_bn(params, cfg) if precision == "int8w" else None
    pln = _forced_plan(mk.plan_widths(precision, scales is not None))
    rpln = ref_mk.MegakernelPlan(tuple(ref_mk.Segment(**dataclasses.asdict(s)) for s in pln.segments), VOL,
                                 ref_mk.VMEM_BUDGET, pln.widths)

    def layer_epilogue(layer, gi):
        bias, scale, offset = ref_quantize.fold_epilogue(layer, bn)
        return bias, scale * ref_quantize.INPUT_SCALE if gi == 0 and precision == "int8w" else scale, offset

    h = pln.segments[0].halo
    xin = ref_quantize.quantize_input(jnp.asarray(x)) if precision == "int8w" else jnp.asarray(x).astype(jnp.bfloat16)
    staging = jnp.pad(xin, [(0, 0)] + [(h, h + p - v) for p, v in zip(pln.padded(pln.segments[0]), VOL)] + [(0, 0)])
    for i, seg in enumerate(pln.segments):
        expect = np.asarray(ref_mk._run_segment(
            staging, rpln.segments[i], rpln, i, ref_params, use_affine=True, fold_affine=None, interpret=True,
            layer_epilogue=layer_epilogue, compute_dtype=jnp.bfloat16, staging_scales=ref_scales,
        ))
        layers, head = ops.megakernel_operands(params, cfg, seg, precision)
        deq, qs = mk.scale_operands(pln, i)
        before = mk.reduced_launches
        got = mk.run_segment(_t(np.asarray(staging)), pln, i, layers, head,
                             scales[seg.start - 1] if deq else None, scales[seg.start + len(seg.dilations) - 1] if qs else None)
        assert mk.reduced_launches == before  # the CPU path launches nothing
        assert got.shape == expect.shape and got.dtype == pln.dtypes(i)[1]
        w = _written(pln, i)
        if got.dtype == torch.int8:
            diff = np.abs(got[w].numpy().astype(np.int32) - expect[w].astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999, (i, diff.max(), np.mean(diff == 0))
        else:
            e = expect[w].astype(np.float32)
            assert np.max(np.abs(got[w].float().numpy() - e)) <= BF16_STEP * np.max(np.abs(e)), i
        staging = jnp.asarray(expect)  # the reference's array, border and all, feeds both
    # int8 staging ran exactly where the plan says
    assert [pln.dtypes(i)[1] for i in range(3)] == (
        [torch.int8, torch.int8, torch.bfloat16] if precision == "int8w" and bn else [torch.bfloat16] * 3)


def test_plain_k2r_is_the_plain_reduced_forward_on_one_layer_segments():
    # one segment a layer at bf16: the same fp32 sums, the same rounding to
    # bf16 after every layer, the same head: bit-equal to the plain forward
    cfg = meshnet.MeshNetConfig(**SMALL)
    params = bridge.params_from_numpy(_np_params(cfg, seed=9), "cpu")
    x = torch.from_numpy(_volume(VOL, seed=10))
    pln = mk.plan_for_config(cfg, VOL, precision="bf16")
    assert [len(s.dilations) for s in pln.segments] == [1, 1, 1]
    got = ops.meshnet_apply_megakernel(params, x, cfg, precision="bf16")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, executors.apply("torch", params, x, cfg, precision="bf16"))


@pytest.mark.parametrize("precision", ["bf16", "int8w"])
def test_staging_border_is_never_read(precision):
    cfg = meshnet.MeshNetConfig(**SMALL)
    params = quantize.prepare_params(bridge.params_from_numpy(_np_params(cfg, seed=11), "cpu"), cfg, precision)
    scales = quantize.staging_scales_from_bn(params, cfg) if precision == "int8w" else None
    pln = _forced_plan(mk.plan_widths(precision, scales is not None))
    pln = mk.MegakernelPlan(pln.segments[:2] + (mk.Segment(3, (2, 1), 5, 5, (5, 12, 14), True, 3),), VOL, pln.widths)
    i, seg = 1, pln.segments[1]
    x_dtype, _ = pln.dtypes(i)
    x = torch.rand((1,) + pln.out_dims(0) + (5,))
    x = torch.randint(0, 100, x.shape).to(torch.int8) if x_dtype == torch.int8 else x.to(torch.bfloat16)
    poisoned = torch.full_like(x, -128) if x_dtype == torch.int8 else torch.full_like(x, float("nan"))
    poisoned[_written(pln, 0)] = x[_written(pln, 0)]
    layers, head = ops.megakernel_operands(params, cfg, seg, precision)
    deq, qs = mk.scale_operands(pln, i)
    args = (layers, head, scales[1] if deq else None, scales[2] if qs else None)
    got = mk.run_segment(poisoned, pln, i, *args)[_written(pln, i)]
    assert torch.equal(got, mk.run_segment(x, pln, i, *args)[_written(pln, i)])


def test_wrapper_rejects_bad_reduced_operands():
    cfg = meshnet.MeshNetConfig(**SMALL)
    params = quantize.prepare_params(bridge.params_from_numpy(_np_params(cfg, seed=12), "cpu"), cfg, "int8w")
    scales = quantize.staging_scales_from_bn(params, cfg)
    pln = _forced_plan(mk.plan_widths("int8w", True))
    pln = mk.MegakernelPlan(pln.segments[:2] + (mk.Segment(3, (2, 1), 5, 5, (5, 12, 14), True, 3),), VOL, pln.widths)
    x = torch.zeros((1,) + pln.out_dims(0) + (5,), dtype=torch.int8)
    layers, head = ops.megakernel_operands(params, cfg, pln.segments[1], "int8w")
    ok = (layers, head, scales[1], scales[2])
    assert mk.run_segment(x, pln, 1, *ok).dtype == torch.int8
    with pytest.raises(TypeError, match="staging array"):
        mk.run_segment(x.to(torch.bfloat16), pln, 1, *ok)
    with pytest.raises(ValueError, match="takes deq"):
        mk.run_segment(x, pln, 1, layers, head, None, scales[2])
    with pytest.raises(ValueError, match="takes deq"):
        mk.run_segment(x, pln, 1, layers, head, scales[1], None)
    with pytest.raises(TypeError, match="w must be"):
        mk.run_segment(x, pln, 1, [(layers[0][0].to(torch.bfloat16),) + layers[0][1:]], head, scales[1], scales[2])
    with pytest.raises(ValueError, match="deq must be"):
        mk.run_segment(x, pln, 1, layers, head, scales[1][:3], scales[2])
    with pytest.raises(ValueError, match="no staging scales"):
        mk.run_segment(x.float(), dataclasses.replace(pln, widths=mk.FP32_WIDTHS), 1, layers, head, scales[1], scales[2])
    with pytest.raises(ValueError, match="widths"):
        ops.meshnet_apply_megakernel(params, torch.zeros(ODD_SHAPE), cfg, pln=pln, precision="bf16")


# ------------------------------------------------------------- forwards ---


def _pair(ref_cfg, seed, init_like=True):
    tree = _np_params(ref_cfg, seed, init_like=init_like)
    x = _volume(VOL, seed + 100)
    return tree, x, jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, "cpu"), _port_cfg(ref_cfg)


def _oracle(ref_params, x, ref_cfg, precision):
    return _f32(ref_executors.apply("xla", ref_params, jnp.asarray(x), ref_cfg, precision=precision))


@pytest.mark.parametrize("init_like", [True, False], ids=["init_weights", "bn_statistics"])
def test_bf16_forward_holds_the_references_gates(init_like):
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    tree, x, ref_params, params, cfg = _pair(ref_cfg, seed=0, init_like=init_like)
    if not init_like:  # tests/test_torch_quantize.py's pair, where the plain forward holds 1e-3
        tree = _np_params(ref_cfg, seed=4)
        ref_params, params = jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, "cpu")
        x = np.random.default_rng(5).random(ODD_SHAPE).astype(np.float32)
    got = ops.meshnet_apply_megakernel(params, torch.from_numpy(x), cfg, precision="bf16")
    assert got.dtype == torch.bfloat16 and got.shape == ODD_SHAPE + (3,)
    # the plain reduced forward's rounding points, bit for bit (one-layer segments)
    assert torch.equal(got, executors.apply("torch", params, torch.from_numpy(x), cfg, precision="bf16"))
    oracle = _oracle(ref_params, x, ref_cfg, "bf16")
    err = np.max(np.abs(_f32(got) - oracle))
    if init_like:
        # logits to 1.5 here: a sum taken in XLA's order that lands on the
        # other side of a bf16 rounding boundary parts by one bf16 step of
        # the logit, up to 2^-8 of the largest (0.0022 at a logit of 0.27)
        assert err <= BF16_STEP * np.max(np.abs(oracle))
        assert np.max(np.abs(_f32(got) - _oracle(ref_params, x, ref_cfg, "fp32"))) <= 1e-2
    else:
        assert err <= 1e-3
    # a batch of two is each member's forward
    xb = torch.from_numpy(np.concatenate([x, _volume(VOL, seed=101)]))
    both = ops.meshnet_apply_megakernel(params, xb, cfg, precision="bf16")
    assert torch.equal(both[:1], got)


def test_int8w_forward_holds_the_references_gates():
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    _, x, ref_params, params, cfg = _pair(ref_cfg, seed=0)
    xt = torch.from_numpy(x)
    oracle, fp32 = _oracle(ref_params, x, ref_cfg, "int8w"), _oracle(ref_params, x, ref_cfg, "fp32")
    widths = mk.plan_widths("int8w", True)
    # no staging: one segment (the reference's own plan at this shape); only
    # the int8 input, its scale folded exactly (tests/test_precision.py:102-112)
    one = mk.MegakernelPlan((mk.Segment(0, (1, 2, 4), 1, 5, VOL, True, 3),), VOL, widths)
    got = ops.meshnet_apply_megakernel(params, xt, cfg, pln=one, precision="int8w")
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(_f32(got) - oracle)) <= 2e-2
    # an int8 input is taken as already quantised
    assert torch.equal(got, ops.meshnet_apply_megakernel(params, quantize.quantize_input(xt), cfg, pln=one, precision="int8w"))
    # the port's own plan at this shape is one segment too: no crossing
    own = mk.plan_for_config(cfg, VOL, precision="int8w")
    assert own.widths == widths and own.crossings == 0
    got = ops.meshnet_apply_megakernel(params, xt, cfg, pln=own, precision="int8w")
    assert np.max(np.abs(_f32(got) - oracle)) <= 2e-2
    # int8 staging (tests/test_precision.py:114-135): forced plans of a
    # segment a layer and of a two-layer segment and one, int8 at every
    # boundary
    one_each = mk.plan_for_config(cfg, VOL, precision="int8w", int8_staging=False).segments
    forced = mk.MegakernelPlan((mk.Segment(0, (1, 2), 1, 5, (5, 6, 14)), mk.Segment(2, (4,), 5, 5, VOL, True, 3)),
                               VOL, widths)
    for pln in (mk.MegakernelPlan(one_each, VOL, widths), forced):
        assert pln.crossings >= 1 and pln.widths == widths
        got = ops.meshnet_apply_megakernel(params, xt, cfg, pln=pln, precision="int8w")
        assert np.max(np.abs(_f32(got) - oracle)) <= 8e-2
        assert np.mean(_f32(got).argmax(-1) == fp32.argmax(-1)) >= 0.95


def test_int8w_forward_stages_where_the_reference_does():
    """Fault F2's case with int8 crossings: gwm_light's 9 layers at 32^3,
    where the reference's plan is layers 0-3, 4 and 5-8, as at 256^3, so
    it stages int8 before layers 4 and 5. The port's own int8w plan (int8
    at those two boundaries, bf16 at the others, as at 256^3) is within
    the reference's 2e-2 (tests/test_precision.py:266) of the reference's
    ``pallas_megakernel`` at int8w (interpret mode); the same segments
    staging int8 at every boundary, as the port's first planner did, are
    not."""
    ref_cfg = ref_meshnet.PAPER_MODELS["gwm_light"]
    vol = (32, 32, 32)
    tree = _np_params(ref_cfg, 7)
    x = _volume(vol, 107)
    cfg = _port_cfg(ref_cfg)
    pln = mk.plan_for_config(cfg, vol, precision="int8w")
    assert pln.int8_at == {4, 5} == mk.plan_for_config(cfg, (256,) * 3, precision="int8w").int8_at
    params, xt = bridge.params_from_numpy(tree, "cpu"), torch.from_numpy(x)
    want = _f32(ref_executors.apply("pallas_megakernel", jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg,
                                    precision="int8w"))
    got = _f32(ops.meshnet_apply_megakernel(params, xt, cfg, precision="int8w"))
    assert np.max(np.abs(got - want)) <= 2e-2
    every = mk.MegakernelPlan(pln.segments, vol, pln.widths)
    assert every.crossings == 8
    got = _f32(ops.meshnet_apply_megakernel(params, xt, cfg, pln=every, precision="int8w"))
    assert np.max(np.abs(got - want)) > 2e-2


def test_no_batchnorm_stages_bf16():
    ref_cfg = ref_meshnet.MeshNetConfig(dilations=(1, 2), use_batchnorm=False)
    _, x, ref_params, params, cfg = _pair(ref_cfg, seed=0)
    pln = mk.plan_for_config(cfg, VOL, precision="int8w")
    assert pln.widths == (2, 1, 1, 2) and len(pln.segments) == 2 and pln.dtypes(1)[0] == torch.bfloat16
    assert quantize.staging_scales_from_bn(params, cfg) is None
    got = ops.meshnet_apply_megakernel(params, torch.from_numpy(x), cfg, precision="int8w")
    assert np.max(np.abs(_f32(got) - _oracle(ref_params, x, ref_cfg, "int8w"))) <= 2e-2
    got16 = ops.meshnet_apply_megakernel(params, torch.from_numpy(x), cfg, precision="bf16")
    assert np.max(np.abs(_f32(got16) - _oracle(ref_params, x, ref_cfg, "fp32"))) <= 3e-2


def test_calibrated_scales_tighten_staging():
    ref_cfg = ref_meshnet.MeshNetConfig(**SMALL)
    _, x, ref_params, params, cfg = _pair(ref_cfg, seed=0)
    fp32 = _oracle(ref_params, x, ref_cfg, "fp32")
    xt = torch.from_numpy(x)

    def staged_err(scales):
        got = ops.meshnet_apply_megakernel(params, xt, cfg, precision="int8w", staging_scales=scales)
        return np.max(np.abs(_f32(got) - fp32))

    prepared = quantize.prepare_params(params, cfg, "int8w")
    bn_err = staged_err(quantize.staging_scales_from_bn(prepared, cfg))
    assert bn_err == staged_err(None)  # the default
    assert staged_err(quantize.calibrate(params, cfg, xt)) <= bn_err + 1e-3


def test_deq_weight_split_reconstructs_the_dequantised_weights():
    """K2r's hi and lo bf16 weights where its first layer dequantises int8
    staging: hi + lo is w deq (fp32) within 2^-16 relative, for int8 codes
    and bf16 weights and staging scales over four decades."""
    rng = np.random.default_rng(23)
    deq = torch.from_numpy((10.0 ** rng.uniform(-3, 1, 5)).astype(np.float32))
    for w in (torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 5, 5)).astype(np.int8)),
              torch.from_numpy(rng.standard_normal((3, 3, 3, 5, 5)).astype(np.float32)).to(torch.bfloat16)):
        hi, lo = mk.deq_weight_split(w, deq)
        assert hi.dtype == lo.dtype == torch.bfloat16
        wd = w.float() * deq[:, None]
        err = (hi.float() + lo.float() - wd).abs()
        assert bool((err <= 2.0**-16 * wd.abs()).all()), float((err / wd.abs().clamp_min(1e-30)).max())


def test_staging_layout_pads_only_the_layout():
    """K2r's staging arrays: bf16 of several channels hold 8 channels a
    group (C = 5: 16 bytes a position), int8 or one channel are packed with
    each x row's pitch padded to 16 bytes; the logical tensor is the same:
    the plain path reads an array of that layout whose pads are poison
    bit-equal to the contiguous one, and the CPU forward never allocates
    the layout."""
    assert mk.staging_strides((2, 10, 12, 14, 5), torch.bfloat16) == (10 * 12 * 14 * 8, 12 * 14 * 8, 14 * 8, 8, 1)
    assert mk.staging_strides((2, 10, 12, 14, 21), torch.bfloat16) == (10 * 12 * 14 * 24, 12 * 14 * 24, 14 * 24, 24, 1)
    assert mk.staging_strides((2, 10, 12, 14, 5), torch.int8) == (10 * 12 * 80, 12 * 80, 80, 5, 1)  # 70 -> 80 bytes
    assert mk.staging_strides((2, 10, 12, 14, 1), torch.bfloat16) == (10 * 12 * 16, 12 * 16, 16, 1, 1)  # 28 -> 32 bytes
    t = mk.staging_empty((2, 10, 12, 14, 5), torch.bfloat16, "cpu")
    assert tuple(t.shape) == (2, 10, 12, 14, 5) and mk.is_staging(t) and not mk.is_staging(t.contiguous())
    cfg = meshnet.MeshNetConfig(dilations=(1, 2))
    port = bridge.params_from_numpy(_np_params(cfg, 29), "cpu")
    for precision in ("bf16", "int8w"):
        prepared = quantize.prepare_params(port, cfg, precision)
        pln = mk.plan_for_config(cfg, (6, 7, 9), precision=precision, smem_budget=20_000)
        assert len(pln.segments) == 2
        seen = []
        real = mk.run_segment

        def spy(x, *a, **kw):
            out = real(x, *a, **kw)
            seen.append((x, a, kw, out))
            return out

        mk.run_segment = spy
        try:
            ops.meshnet_apply_megakernel(prepared, torch.rand((1, 6, 7, 9)), cfg, precision=precision)
        finally:
            mk.run_segment = real
        assert len(seen) == 2
        for x, a, kw, out in seen:
            assert x.is_contiguous() and out.is_contiguous(), precision
            laid = mk.staging_empty(tuple(x.shape), x.dtype, "cpu")
            flat = torch.as_strided(laid, (x.shape[0] * laid.stride(0),), (1,))
            flat.fill_(-128 if x.dtype == torch.int8 else float("nan"))  # the pads keep this poison
            laid.copy_(x)
            i = a[1]
            o, padded = pln.out_halo(i), pln.padded(pln.segments[i])
            region = (slice(None),) + tuple(slice(o, o + p) for p in padded)
            assert torch.equal(mk.run_segment(laid, *a, **kw)[region], out[region]), (precision, i)
