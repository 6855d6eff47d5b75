"""The port's megakernel (K2's planner, its plain path and the
``cuda_megakernel`` executor) against the reference on the CPU: the
planner's partition, shared-memory and byte-model rules, the plain path
against ``repro.core.meshnet.apply`` and against the reference's Pallas
megakernel in interpret mode on the same plan, and ``pipeline.run``
against the reference's segmentation."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.core import pipeline as ref_pipeline
from repro.kernels import megakernel as ref_mk
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.core import executors, meshnet, pipeline
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops, ref
from repro_torch.telemetry import traffic

ODD_SHAPE = (1, 10, 12, 14)
BATCHED_ODD = (2, 9, 17, 13)
FULL_SCHEDULE = (1, 2, 4, 8, 16, 8, 4, 2, 1)
MEGA_ATOL = 1e-4  # megakernel logits (tests/test_megakernel.py)
SEGMENT_ATOL = 1e-5  # one segment, the same arithmetic in another order
PAPER_VOL = (256, 256, 256)
#: the tiles of the one-layer segments that the time-priced planner chooses,
#: by (model, volume, batch) and policy; "small" is gwm_light at dilations
#: (1, 2, 4). fp32: K2's plans, as the first time-only planner chose them.
#: bf16: K2r's, priced by its tensor-core kernel's input rows
#: (``_lp_segment_work``; re-pinned when that kernel replaced the CUDA-core
#: one: its layout and time model moved them).
_T16 = (16, 16, 256)
_LP256 = [(16, 32, 64)] * 9
PARENT_PLANS = {
    ("gwm_light", PAPER_VOL, 1): {"fp32": [(3, 4, 256)] + [_T16] * 3 + [(8, 32, 256)] + [_T16] * 4,
                                  "bf16": _LP256},
    ("gwm_large", PAPER_VOL, 1): {"fp32": [(2, 4, 128), (6, 4, 128), (3, 8, 128)] + [(16, 32, 128)] * 3 + [
        (3, 8, 128), (6, 4, 128), (4, 6, 128)],
                                  "bf16": [(8, 128, 32), (4, 256, 32)] * 4 + [(8, 128, 32)]},
    ("gwm_light", (156, 256, 256), 1): {"fp32": [(2, 4, 256)] * 2 + [(10, 16, 256)] * 2 + [(5, 32, 256)] + [
        (10, 16, 256)] * 2 + [(2, 4, 256)] * 2,
                                        "bf16": [(4, 20, 256)] + [(20, 16, 64)] * 3 + [(10, 32, 64)] + [
                                            (20, 16, 64)] * 4},
    ("gwm_light", (10, 12, 14), 1): {"fp32": [(2, 4, 14)] * 2 + [(2, 2, 14)] * 5 + [(2, 4, 14)] * 2,
                                     "bf16": [(2, 3, 14)] + [(2, 2, 14)] * 7 + [(2, 3, 14)]},
    ("gwm_light", (9, 17, 13), 2): {"fp32": [(3, 2, 14), (2, 4, 14)] + [(2, 2, 14)] * 5 + [(2, 4, 14), (3, 2, 14)],
                                    "bf16": [(2, 3, 14)] + [(2, 2, 14)] * 7 + [(2, 3, 14)]},
    ("gwm_light", (16, 8, 8), 1): {"fp32": [(2, 4, 8)] * 2 + [(2, 2, 8)] * 5 + [(2, 4, 8)] * 2,
                                   "bf16": [(2, 3, 8)] + [(2, 2, 8)] * 7 + [(2, 3, 8)]},
    ("small", (16, 8, 8), 1): {"fp32": [(2, 4, 8), (2, 4, 8), (2, 2, 8)], "bf16": [(2, 3, 8), (2, 2, 8), (2, 2, 8)]},
    ("small", (30, 8, 8), 1): {"fp32": [(2, 4, 8), (2, 4, 8), (2, 2, 8)], "bf16": [(2, 3, 8), (2, 2, 8), (2, 2, 8)]},
    ("small", (10, 12, 14), 1): {"fp32": [(2, 4, 14), (2, 4, 14), (2, 2, 14)],
                                 "bf16": [(2, 3, 14), (2, 2, 14), (2, 2, 14)]},
}


def _np_params(cfg, seed):
    """Weights and non-trivial BatchNorm statistics, made with numpy."""
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


def _reference_plan(pln, budget):
    """The port's plan, made under ``budget``, as the reference's Segment
    and MegakernelPlan."""
    segments = tuple(ref_mk.Segment(**dataclasses.asdict(s)) for s in pln.segments)
    return ref_mk.MegakernelPlan(segments=segments, vol=pln.vol, vmem_budget=budget)


def _plan(vol, *segments):
    """A plan with the given segments, each (start, dilations, cin, C,
    tile, fuse_head, classes): multi-layer segments that the time-priced
    planner does not choose at these volumes (the byte-priced planner of
    the first K2 did)."""
    return mk.MegakernelPlan(tuple(mk.Segment(*s) for s in segments), tuple(vol))


def _written(pln, i):
    o = pln.out_halo(i)
    return (slice(None),) + tuple(slice(o, o + p) for p in pln.padded(pln.segments[i])) + (slice(None),)


class TestPlanner:
    @pytest.mark.parametrize("name", ["gwm_light", "brain_mask_fast", "subvolume_gwm_failsafe", "atlas_104"])
    def test_segments_partition_schedule(self, name):
        cfg = meshnet.PAPER_MODELS[name]
        for vol, budget in ((PAPER_VOL, mk.SMEM_BUDGET), (ODD_SHAPE[1:], 60_000)):
            pln = mk.plan_for_config(cfg, vol, smem_budget=budget)
            covered = []
            for seg in pln.segments:
                assert seg.start == len(covered)
                assert seg.cin == (cfg.in_channels if seg.start == 0 else cfg.channels)
                covered.extend(seg.dilations)
            assert tuple(covered) == cfg.dilations
            # only the last segment fuses the head
            assert [s.fuse_head for s in pln.segments] == [False] * (len(pln.segments) - 1) + [True]

    def test_buffer_sizes_shrink_to_the_tile(self):
        pln = mk.plan_for_config(meshnet.PAPER_MODELS["gwm_light"], PAPER_VOL)
        deep = _plan(PAPER_VOL, (0, (1, 2), 1, 5, (16, 16, 20), False, 3), (2, (4, 8, 16, 8, 4), 5, 5, (8, 8, 8), False, 3),
                     (7, (2, 1), 5, 5, (16, 16, 32), True, 3))
        assert len(pln.segments) > 1 and any(len(s.dilations) > 1 for s in deep.segments)
        for seg in pln.segments + deep.segments:
            sizes = seg.buffer_sizes()
            assert sizes[0] == tuple(t + 2 * seg.halo for t in seg.tile)
            for d, a, b in zip(seg.dilations, sizes, sizes[1:]):
                assert b == tuple(s - 2 * d for s in a)
            assert sizes[-1] == seg.tile

    @pytest.mark.parametrize("budget", [mk.SMEM_BUDGET, 100_000, 50_000])
    @pytest.mark.parametrize("name", ["gwm_light", "brain_mask_fast", "gwm_large", "atlas_104"])
    def test_shared_memory_within_budget(self, name, budget):
        pln = mk.plan_for_config(meshnet.PAPER_MODELS[name], PAPER_VOL, smem_budget=budget)
        for seg in pln.segments:
            assert mk._segment_smem_bytes(seg) <= budget
            # what K2 allocates: the segment's parameters, ping and pong at
            # the odd channel stride C | 1, then the first layer's ring
            params, ping, pong, ring = mk._smem_layout(seg)
            hidden = [int(np.prod(s)) * (seg.channels | 1) for s in seg.buffer_sizes()[1:-1]]
            assert ping == max(hidden[0::2], default=0) and pong == max(hidden[1::2], default=0)
            assert mk._segment_smem_bytes(seg) == 4 * (params + ping + pong + ring)

    @pytest.mark.parametrize("name", ["gwm_light", "brain_mask_fast"])
    def test_paper_volume_plans_fit_one_block(self, name):
        pln = mk.plan_for_config(meshnet.PAPER_MODELS[name], PAPER_VOL)
        assert mk.SMEM_BUDGET == 232_448
        assert max(mk._segment_smem_bytes(s) for s in pln.segments) <= mk.SMEM_BUDGET
        # the per-layer path's multiply-adds, all 27 taps, and the head
        cfg = meshnet.PAPER_MODELS[name]
        v = int(np.prod(PAPER_VOL))
        per_layer = v * 27 * cfg.channels * (cfg.in_channels + cfg.channels * (len(cfg.dilations) - 1))
        per_layer += v * cfg.channels * cfg.num_classes
        assert pln.operations() > per_layer  # the halo each segment recomputes

    @pytest.mark.parametrize("batch", [1, 3])
    @pytest.mark.parametrize("name,vol", [("gwm_light", PAPER_VOL), ("atlas_104", PAPER_VOL), ("gwm_large", (10, 12, 14))])
    def test_hbm_bytes_is_the_traffic_model_and_the_dp_cost(self, name, vol, batch):
        cfg = meshnet.PAPER_MODELS[name]
        pln = mk.plan_for_config(cfg, vol, batch=batch)
        cost, segments = mk._dp(cfg.dilations, cfg.in_channels, cfg.channels, cfg.num_classes, vol, mk.SMEM_BUDGET, batch)
        assert segments == pln.segments
        # the DP minimises modeled time; the bytes it reports are the reference's formula
        assert cost == pytest.approx(pln.modeled_ms(batch), rel=1e-12)
        assert pln.hbm_bytes(batch) == traffic.meshnet_megakernel_bytes(cfg, vol, batch=batch)
        # the reference's formula on the same segments (megakernel.py:176-269)
        assert pln.hbm_bytes(batch) == _reference_plan(pln, mk.SMEM_BUDGET).hbm_bytes(batch=batch)
        assert pln.hbm_bytes(batch) == mk._input_pad_bytes(pln.segments[0], vol, batch) + sum(
            pln.segment_hbm_bytes(i, batch) for i in range(len(pln.segments))
        )

    @pytest.mark.parametrize("budget", [mk.SMEM_BUDGET, 40_000, 12_000])
    @pytest.mark.parametrize("batch", [1, 2])
    def test_dp_is_the_minimum_of_an_exhaustive_search(self, budget, batch):
        cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
        vol = (10, 12, 14)
        n = len(cfg.dilations)
        tiles = list(itertools.product(*[mk._axis_candidates(v) for v in vol]))
        best = float("inf")
        for cuts in itertools.chain.from_iterable(itertools.combinations(range(1, n), r) for r in range(n)):
            bounds = (0,) + cuts + (n,)
            total = 0
            for i, j in zip(bounds, bounds[1:]):
                costs = []
                for tile in tiles:
                    seg = mk.Segment(i, cfg.dilations[i:j], cfg.in_channels if i == 0 else cfg.channels,
                                     cfg.channels, tile, j == n, cfg.num_classes)
                    if mk._segment_smem_bytes(seg) <= budget:
                        c = float(mk._segment_modeled_ms(seg, vol, batch))
                        costs.append(c + (float(mk._input_pad_ms(seg, vol, batch)) if i == 0 else 0.0))
                total += min(costs, default=float("inf"))
            best = min(best, total)
        pln = mk.plan_for_config(cfg, vol, smem_budget=budget, batch=batch)
        assert pln.modeled_ms(batch) == pytest.approx(best, rel=1e-12)

    def test_operations_count_the_halo_recompute(self):
        # one-layer segments whose tiles are the volume recompute nothing
        cfg = meshnet.MeshNetConfig(channels=10, num_classes=2, dilations=(1, 2, 4))
        vol = (10, 12, 14)
        pln = _plan(vol, (0, (1,), 1, 10, vol, False, 2), (1, (2,), 10, 10, vol, False, 2), (2, (4,), 10, 10, vol, True, 2))
        assert all(len(s.dilations) == 1 and s.tile == vol for s in pln.segments)
        v = int(np.prod(vol))
        assert pln.operations() == v * 27 * (1 * 10 + 10 * 10 * 2) + v * 10 * 2
        assert pln.operations(batch=3) == 3 * pln.operations()
        # a two-layer segment recomputes its first layer's halo
        two = _plan(vol, (0, (1, 2), 1, 10, vol, False, 2), (2, (4,), 10, 10, vol, True, 2))
        assert any(len(s.dilations) > 1 for s in two.segments)
        assert two.operations() > pln.operations()

    @pytest.mark.parametrize(
        "cfg,budget,binding,need",
        [
            # layer 2 carries the 104-class head, alone at tile (2, 2, 2): weights
            # 27*21*24 (row stride 21 -> 24), bias/scale/offset 3*21 -> 64, head
            # 21*104 + 104 = 2,288, and the ring of the 4 warps that have rows
            # (2 z rows x 2 rows): 4 x 2 slots of ceil4((2 + 2*min(4, 2)) x 21)
            # + 4 = 132 floats; 17,016 floats
            (meshnet.MeshNetConfig(channels=21, num_classes=104, dilations=(1, 2, 4)), 50_000, 2, 68_064),
            # a 64-channel input makes layer 0 the widest: 27*64*24 + 64 floats,
            # and a ring of 4 x 2 slots of ceil4((2 + 2*1) x 65) + 4 = 264 floats;
            # 43,648 floats
            (meshnet.MeshNetConfig(in_channels=64, channels=21, dilations=(1, 2)), 100_000, 0, 174_592),
        ],
    )
    def test_infeasible_budget_names_the_binding_layer(self, cfg, budget, binding, need):
        with pytest.raises(ValueError, match=rf"infeasible: layer {binding} .* needs {need} bytes .* {budget}-byte budget"):
            mk.plan_for_config(cfg, (16, 16, 16), smem_budget=budget)

    @pytest.mark.parametrize(
        "blocks,per_sm,factor",
        [
            (264, 2, 1.0),  # exactly one wave of 132 SMs x 2
            (528, 2, 1.0),
            (265, 2, 2 / (265 / 264)),  # one block over: a second, nearly empty wave
            (132, 1, 1.0),
            (66, 1, 2.0),  # half the SMs idle
            (1024, 8, 1 / (1024 / 1056)),
        ],
    )
    def test_wave_quantisation(self, blocks, per_sm, factor):
        assert mk._wave_quantisation(blocks, per_sm) == pytest.approx(factor, rel=1e-12)

    def test_blocks_per_sm_take_the_scarcest_resource(self):
        # shared memory: 228 KB an SM, 1 KB reserved a block
        assert mk._blocks_per_sm(96_540, 5) == min(2, self._by_regs(5))  # 233,472 // 97,564
        assert mk._blocks_per_sm(150_000, 5) == 1
        # registers: a block of 128 threads at REGISTERS[C] rounded up to 8 each
        for c in (5, 10, 18, 21):
            assert mk._blocks_per_sm(1_000, c) == min(16, self._by_regs(c))

    @staticmethod
    def _by_regs(c):
        return 65_536 // (-(-mk.REGISTERS[c] // 8) * 8 * 128)

    @pytest.mark.parametrize("name", ["gwm_light", "brain_mask_fast"])
    def test_paper_volume_plan_fills_the_sms(self, name):
        pln = mk.plan_for_config(meshnet.PAPER_MODELS[name], PAPER_VOL)
        for i, seg in enumerate(pln.segments):
            blocks = pln.segment_blocks(i)
            assert blocks >= mk.SMS, (i, seg, blocks)
            assert blocks == int(np.prod([-(-v // t) for v, t in zip(PAPER_VOL, seg.tile)]))
            per_sm = mk._blocks_per_sm(mk._segment_smem_bytes(seg), seg.channels)
            assert pln.segment_waves(i) == pytest.approx(blocks / (mk.SMS * per_sm))
        assert pln.modeled_ms() == pytest.approx(
            float(mk._input_pad_ms(pln.segments[0], PAPER_VOL)) + sum(pln.segment_modeled_ms(i) for i in range(len(pln.segments)))
        )

    def test_segment_layout_is_hand_counted(self):
        # two layers 1 -> 5 -> 5 (d 1, 2) with the 3-class head, tile (4, 4, 8)
        seg = mk.Segment(0, (1, 2), 1, 5, (4, 4, 8), True, 3)
        # weights at row stride 8; bias, scale, offset 15 -> 16; the head 18 -> 20
        params = 27 * 1 * 8 + 16 + 27 * 5 * 8 + 16 + 20
        ping = (4 + 4) * (4 + 4) * (8 + 4) * 5  # layer 0's output, the tile grown by 2 a side, stride 5
        # layer 0's region: 8 z rows x 4 groups of 2 rows x 1 chunk = 32 items, so
        # all 4 warps stage; slots of ceil4((12 + 2 d) x (1 | 1)) + 4 floats
        ring = 4 * 2 * (16 + 4)
        assert mk._smem_layout(seg) == (params, ping, 0, ring)
        assert mk._segment_smem_bytes(seg) == 4 * (1348 + 3840 + 160) == 21_392
        # one 5 -> 5 layer at d = 16 over a 256-wide tile: boxes of 256 + 32 positions
        one = mk.Segment(4, (16,), 5, 5, (16, 16, 256))
        assert mk._smem_layout(one) == (27 * 5 * 8 + 16, 0, 0, 4 * 2 * (288 * 5 + 4))
        # an even width pads the hidden stride to odd: C = 10 -> 11
        wide = mk.Segment(3, (1, 1), 10, 10, (2, 2, 2))
        assert mk._smem_layout(wide) == (2 * (27 * 10 * 12 + 32), 4 * 4 * 4 * 11, 0, 4 * 2 * (6 * 11 + 2 + 4))
        # a 2^3 tile alone: 2 z rows x 1 group of 2 rows, so two warps stage
        assert mk._smem_layout(mk.Segment(3, (1,), 10, 10, (2, 2, 2)))[3] == 2 * 2 * (4 * 11 + 4)
        assert [mk._row_groups(n, d, m) for n, d, m in ((256, 16, 2), (16, 16, 2), (12, 4, 2), (14, 16, 1))] == [
            128, 16, 8, 14]

    def test_plan_is_memoised_and_fp32_only(self):
        # memoised per policy (and, under int8w, per staging width): a plan
        # made for fp32 is never handed to bf16 (tests/test_precision.py::
        # test_precision_plans_cached_separately)
        cfg = meshnet.PAPER_MODELS["gwm_light"]
        plans = {}
        for precision, staging in (("fp32", None), ("bf16", None), ("int8w", True), ("int8w", False)):
            pln = mk.plan_for_config(cfg, PAPER_VOL, precision=precision, int8_staging=staging)
            assert pln is mk.plan_for_config(cfg, PAPER_VOL, precision=precision, int8_staging=staging)
            assert pln.widths == mk.plan_widths(precision, staging)
            plans[(precision, staging)] = pln
        assert len({id(p) for p in plans.values()}) == 4
        assert plans[("fp32", None)] is mk.plan_for_config(cfg, PAPER_VOL)
        # with BatchNorm, int8w stages int8 unless told otherwise
        assert plans[("int8w", True)] is mk.plan_for_config(cfg, PAPER_VOL, precision="int8w")
        assert [p.widths for p in plans.values()] == [(4, 4, 4, 4), (2, 2, 2, 2), (2, 1, 1, 1), (2, 1, 1, 2)]

    @pytest.mark.parametrize("precision", ["fp32", "bf16"])
    @pytest.mark.parametrize("case", sorted(PARENT_PLANS), ids=lambda c: "-".join(map(str, c)).replace(" ", ""))
    def test_fp32_and_bf16_plans_are_the_time_priced_ones(self, case, precision):
        """Only int8 staging changes the objective: at fp32 and bf16 the plan
        is the one the time-only DP made before, segment for segment and
        tile for tile (written down from that planner), with no crossing."""
        name, vol, batch = case
        cfg = meshnet.MeshNetConfig(channels=5, num_classes=3, dilations=(1, 2, 4)) if name == "small" else (
            meshnet.PAPER_MODELS[name])
        pln = mk.plan_for_config(cfg, vol, precision=precision, batch=batch)
        want = PARENT_PLANS[case][precision]
        assert [(s.start, len(s.dilations), s.tile) for s in pln.segments] == [
            (i, 1, tuple(t)) for i, t in enumerate(want)]
        assert pln.crossings == 0

    @pytest.mark.parametrize("name,vol", [("gwm_light", PAPER_VOL), ("brain_mask_fast", PAPER_VOL),
                                          ("gwm_light", (156, 256, 256)), ("gwm_light", ODD_SHAPE[1:]),
                                          ("atlas_104", (16, 8, 8)), ("gwm_light", (16, 8, 8))])
    def test_int8_staging_stages_where_the_references_plan_does(self, name, vol):
        """Under int8w with int8 staging the plan stages int8 exactly at the
        boundaries of the reference's own plan at that volume (the copy of
        its VMEM planner, ``_reference_starts``, agrees with it), no segment
        spans one, every other boundary stages bf16, and ``crossings``
        counts the int8 ones; with bf16 staging there is none."""
        ref_plan = ref_mk.plan_for_config(ref_meshnet.PAPER_MODELS[name], vol, precision="int8w")
        cuts = {seg.start for seg in ref_plan.segments[1:]}
        cfg = meshnet.PAPER_MODELS[name]
        pln = mk.plan_for_config(cfg, vol, precision="int8w")
        assert pln.widths == (2, 1, 1, 1) and pln.int8_at == cuts and pln.crossings == len(cuts) > 0
        starts = [seg.start for seg in pln.segments]
        assert cuts <= set(starts)
        for i, seg in enumerate(pln.segments):
            want = torch.int8 if i == 0 or seg.start in cuts else torch.bfloat16
            assert pln.dtypes(i)[0] == want
        # time-priced within the cuts: the bf16-staged plan where it has the same boundaries
        staged16 = mk.plan_for_config(cfg, vol, precision="int8w", int8_staging=False)
        assert staged16.crossings == 0
        if cuts <= {seg.start for seg in staged16.segments}:
            same_cuts = dataclasses.replace(staged16, widths=pln.widths, int8_at=cuts)
            assert pln.modeled_ms() <= same_cuts.modeled_ms() * (1 + 1e-12)


class TestParity:
    """ops.meshnet_apply_megakernel (the cuda_megakernel backend, plain
    path on the CPU) against the reference's oracle, meshnet.apply."""

    @pytest.mark.parametrize("budget", [mk.SMEM_BUDGET, 60_000])
    @pytest.mark.parametrize("name", sorted(ref_meshnet.PAPER_MODELS))
    def test_paper_models(self, name, budget):
        ref_cfg = dataclasses.replace(ref_meshnet.PAPER_MODELS[name], dilations=(1, 2, 4))
        self._parity(ref_cfg, ODD_SHAPE, seed=3, smem_budget=budget)

    def test_no_batchnorm(self):
        self._parity(ref_meshnet.MeshNetConfig(dilations=(1, 2, 4), use_batchnorm=False), ODD_SHAPE, seed=4)

    def test_full_schedule_batched_odd(self):
        self._parity(ref_meshnet.MeshNetConfig(dilations=FULL_SCHEDULE), BATCHED_ODD, seed=5, smem_budget=40_000)

    def _parity(self, ref_cfg, shape, seed, smem_budget=mk.SMEM_BUDGET):
        tree = _np_params(ref_cfg, seed)
        x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
        expect = ref_meshnet.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg)
        cfg = _port_cfg(ref_cfg)
        pln = mk.plan_for_config(cfg, shape[1:], smem_budget=smem_budget, batch=shape[0])
        before = mk.launches
        got = ops.meshnet_apply_megakernel(bridge.params_from_numpy(tree, "cpu"), torch.from_numpy(x), cfg, pln=pln)
        assert mk.launches == before  # the CPU path launches nothing
        assert got.shape == shape + (cfg.num_classes,)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=MEGA_ATOL)

    def test_segments_against_pallas_megakernel_interpret(self):
        # The TPU kernel itself, segment by segment in interpret mode, on the
        # port's 3-segment plan (tiles below 8 and off multiples of 8); each
        # staging array's written region is held to the port's plain K2.
        ref_cfg = ref_meshnet.MeshNetConfig(dilations=(1, 2, 4, 2, 1))
        cfg = _port_cfg(ref_cfg)
        tree = _np_params(ref_cfg, seed=7)
        x = np.random.default_rng(8).standard_normal(BATCHED_ODD + (1,)).astype(np.float32)
        pln = _plan(BATCHED_ODD[1:], (0, (1, 2), 1, 5, (5, 6, 14), False, 3), (2, (4,), 5, 5, (10, 20, 14), False, 3),
                    (3, (2, 1), 5, 5, (10, 6, 14), True, 3))
        assert len(pln.segments) == 3
        assert any(t < 8 or t % 8 for s in pln.segments for t in s.tile)
        rpln = _reference_plan(pln, 40_000)
        ref_params = jax.tree.map(jnp.asarray, tree)
        params = bridge.params_from_numpy(tree, "cpu")
        h = pln.segments[0].halo
        pad = [(0, 0)] + [(h, h + p - v) for p, v in zip(pln.padded(pln.segments[0]), pln.vol)] + [(0, 0)]
        staging = np.pad(x, pad)
        for i, seg in enumerate(pln.segments):
            expect = ref_mk._run_segment(
                jnp.asarray(staging), rpln.segments[i], rpln, i, ref_params,
                use_affine=True, fold_affine=ref_ops.fold_batchnorm, interpret=True,
            )
            got = ref.megakernel_segment(torch.from_numpy(staging), pln, i, *ops.megakernel_operands(params, cfg, seg))
            assert got.shape == expect.shape
            w = _written(pln, i)
            np.testing.assert_allclose(got[w].numpy(), np.asarray(expect)[w], atol=SEGMENT_ATOL)
            staging = np.array(expect)  # the reference's array, border and all, feeds both
        np.testing.assert_allclose(
            staging[:, : pln.vol[0], : pln.vol[1], : pln.vol[2]],
            np.asarray(ref_meshnet.apply(ref_params, jnp.asarray(x), ref_cfg)),
            atol=MEGA_ATOL,
        )

    def test_staging_border_is_never_read(self):
        cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
        params = bridge.params_from_numpy(_np_params(cfg, seed=9), "cpu")
        pln = mk.plan_for_config(cfg, ODD_SHAPE[1:], smem_budget=40_000)
        seg = pln.segments[1]
        x = torch.randn((1,) + pln.out_dims(0) + (cfg.channels,))
        poisoned = torch.full_like(x, float("nan"))
        poisoned[_written(pln, 0)] = x[_written(pln, 0)]
        operands = ops.megakernel_operands(params, cfg, seg)
        got = ref.megakernel_segment(poisoned, pln, 1, *operands)[_written(pln, 1)]
        assert torch.isfinite(got).all()
        assert torch.equal(got, ref.megakernel_segment(x, pln, 1, *operands)[_written(pln, 1)])

    def test_four_dim_input_and_plan_volume(self):
        cfg = meshnet.MeshNetConfig(dilations=(1, 2))
        params = bridge.params_from_numpy(_np_params(cfg, seed=10), "cpu")
        x = torch.randn(ODD_SHAPE)
        assert torch.equal(
            ops.meshnet_apply_megakernel(params, x, cfg), ops.meshnet_apply_megakernel(params, x[..., None], cfg)
        )
        with pytest.raises(ValueError, match="plan is for volume"):
            ops.meshnet_apply_megakernel(params, x, cfg, pln=mk.plan_for_config(cfg, (8, 8, 8)))

    def test_wrapper_rejects_bad_operands(self):
        cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
        params = bridge.params_from_numpy(_np_params(cfg, seed=11), "cpu")
        pln = _plan(ODD_SHAPE[1:], (0, (1, 2), 1, 5, (5, 6, 14), False, 3), (2, (4,), 5, 5, (10, 12, 14), True, 3))
        layers, head = ops.megakernel_operands(params, cfg, pln.segments[0])
        h = pln.segments[0].halo
        x = torch.zeros((1,) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (1,))
        with pytest.raises(ValueError, match="layers"):
            mk.run_segment(x, pln, 0, layers[:1], head)
        with pytest.raises(ValueError, match="head"):
            mk.run_segment(x, pln, 0, layers, (torch.zeros(5, 3), torch.zeros(3)))
        with pytest.raises(ValueError, match="too small"):
            mk.run_segment(x[:, :-h - 1], pln, 0, layers, head)
        with pytest.raises(ValueError, match="Z, Y, X, 1"):
            mk.run_segment(x.repeat(1, 1, 1, 1, 2), pln, 0, layers, head)
        bad = [(torch.zeros(3, 3, 3, 2, 5),) + layers[0][1:]] + layers[1:]
        with pytest.raises(ValueError, match="w must be"):
            mk.run_segment(x, pln, 0, bad, head)


class TestPipeline:
    SMALL = dict(dilations=(1, 2, 4))

    @pytest.mark.parametrize("mode", ["full", "streaming"])
    def test_pipeline_gives_the_reference_segmentation(self, mode):
        ref_cfg = ref_meshnet.MeshNetConfig(channels=5, num_classes=3, **self.SMALL)
        ref_mcfg = ref_meshnet.MeshNetConfig(channels=5, num_classes=2, **self.SMALL)
        tree, mtree = _np_params(ref_cfg, seed=20), _np_params(ref_mcfg, seed=21)
        rng = np.random.default_rng(22)
        vol = (rng.random((14, 16, 12)) * 100).astype(np.float32)  # non-cubic: conform resamples
        kw = dict(volume_shape=(16, 16, 16), mode=mode, use_cropping=True, min_component_size=4)
        expect = ref_pipeline.run(
            ref_pipeline.PipelineConfig(model=ref_cfg, executor="xla", **kw),
            jax.tree.map(jnp.asarray, tree), jnp.asarray(vol),
            mask_model=(jax.tree.map(jnp.asarray, mtree), ref_mcfg),
        )
        cfg, mcfg = _port_cfg(ref_cfg), _port_cfg(ref_mcfg)
        got = pipeline.run(
            pipeline.PipelineConfig(model=cfg, executor="cuda_megakernel", **kw),
            bridge.params_from_numpy(tree, "cpu"), vol,
            mask_model=(bridge.params_from_numpy(mtree, "cpu"), mcfg), device="cpu",
        )
        assert got.record.status == expect.record.status == "ok"
        assert got.record.executor == "cuda_megakernel"
        assert executors.REFERENCE_NAMES[got.record.executor] == "pallas_megakernel"
        assert got.record.crop_size == expect.record.crop_size
        assert got.record.hbm_bytes_modeled == traffic.meshnet_megakernel_bytes(cfg, (16, 16, 16))
        np.testing.assert_array_equal(got.segmentation.numpy(), np.asarray(expect.segmentation))

    @pytest.mark.parametrize("which", ["main", "mask"])
    def test_unplannable_model_fails_vmem_oom(self, which):
        wide = dict(channels=4096, dilations=(16,))
        ok = dict(channels=5, dilations=(1,))
        main_kw, mask_kw = (wide, ok) if which == "main" else (ok, wide)
        ref_cfg, ref_mcfg = ref_meshnet.MeshNetConfig(**main_kw), ref_meshnet.MeshNetConfig(num_classes=2, **mask_kw)
        kw = dict(volume_shape=(64, 64, 64), use_cropping=True)
        expect = ref_pipeline.run(
            ref_pipeline.PipelineConfig(model=ref_cfg, executor="pallas_megakernel", **kw),
            None, jnp.zeros((64, 64, 64)), mask_model=(None, ref_mcfg),
        )
        got = pipeline.run(
            pipeline.PipelineConfig(model=_port_cfg(ref_cfg), executor="cuda_megakernel", **kw),
            None, np.zeros((64, 64, 64), np.float32), mask_model=(None, _port_cfg(ref_mcfg)), device="cpu",
        )
        assert got.segmentation is None
        assert got.record.status == expect.record.status == "fail"
        assert got.record.fail_type == expect.record.fail_type == "vmem_oom"

    def test_records_carry_each_executors_modeled_bytes(self):
        cfg = meshnet.MeshNetConfig(**self.SMALL)
        params = bridge.params_from_numpy(_np_params(cfg, seed=30), "cpu")
        vol = np.random.default_rng(31).random((16, 16, 16)).astype(np.float32)
        expected = {
            "torch": traffic.meshnet_plain_bytes(cfg, (16, 16, 16)),
            "cuda_fused": traffic.meshnet_fused_bytes(cfg, (16, 16, 16)),
            "cuda_megakernel": traffic.meshnet_megakernel_bytes(cfg, (16, 16, 16)),
        }
        segs = {}
        for ex, b in expected.items():
            pc = pipeline.PipelineConfig(model=cfg, volume_shape=(16, 16, 16), executor=ex, min_component_size=4)
            res = pipeline.run(pc, params, vol, device="cpu")
            assert res.record.executor == ex and res.record.hbm_bytes_modeled == b
            assert executors.modeled_hbm_bytes(ex, cfg, (16, 16, 16), device="cpu") == b
            segs[ex] = res.segmentation
        assert torch.equal(segs["torch"], segs["cuda_megakernel"])

    def test_fused_bytes_count_each_layer_once(self):
        cfg = meshnet.MeshNetConfig(channels=5, num_classes=3, dilations=(1, 2))
        v = 10 * 12 * 14
        layers = (v * (1 + 5) + 27 * 1 * 5 + 15) + (v * (5 + 5) + 27 * 5 * 5 + 15)
        head = v * (5 + 3) + 5 * 3 + 3
        assert traffic.meshnet_fused_bytes(cfg, (10, 12, 14)) == 4 * (layers + head)
        weights = (27 * 5 + 15) + (27 * 25 + 15) + 18
        assert traffic.meshnet_fused_bytes(cfg, (10, 12, 14), batch=2) == 4 * (2 * (layers + head - weights) + weights)

    def test_auto_stays_cuda_fused_on_the_card(self):
        assert executors.resolve("auto", device="cuda") == "cuda_fused"
        assert executors.resolve("cuda_megakernel", device="cpu") == "cuda_megakernel"
