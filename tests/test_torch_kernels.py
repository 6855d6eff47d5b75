"""Port kernels on the CPU (their plain path) against the reference: K1's
wrapper against repro.kernels.ref and the Pallas K1 in interpret mode,
and the fused forward against repro.core.meshnet.apply."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.kernels import dilated_conv3d as ref_conv_kernel
from repro.kernels import ref as ref_kernels
from repro_torch import bridge
from repro_torch.core import executors, meshnet
from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import ops, quantize

ODD_SHAPE = (1, 10, 12, 14)
KERNEL_ATOL = 5e-5  # tests/test_kernels.py
FUSED_ATOL = 2e-4  # tests/test_executors.py


def _conv_inputs(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal(shape + (cin,)).astype(f32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(f32)
    b = (rng.standard_normal(cout) * 0.1).astype(f32)
    s = (0.5 + rng.random(cout)).astype(f32)
    o = (rng.standard_normal(cout) * 0.1).astype(f32)
    return x, w, b, s, o


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


class TestDilatedConv3D:
    @pytest.mark.parametrize("affine", [False, True])
    @pytest.mark.parametrize("cin,cout", [(1, 5), (5, 5), (21, 21)])
    @pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
    def test_against_reference_oracle(self, dilation, cin, cout, affine):
        x, w, b, s, o = _conv_inputs(dilation * 31 + cin, (2, 9, 10, 11), cin, cout)
        kw = dict(dilation=dilation, fuse_affine=affine)
        ref_kw = dict(kw, scale=jnp.asarray(s), offset=jnp.asarray(o)) if affine else kw
        expect = ref_kernels.dilated_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **ref_kw)
        port_kw = dict(kw, scale=torch.from_numpy(s), offset=torch.from_numpy(o)) if affine else kw
        before = conv_kernel.launches
        got = ops.dilated_conv3d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), **port_kw)
        assert conv_kernel.launches == before  # the CPU path launches nothing
        assert got.shape == (2, 9, 10, 11, cout)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=KERNEL_ATOL)

    def test_against_pallas_k1_interpret(self):
        # The TPU kernel itself, one fused layer at 8^3 in interpret mode.
        x, w, b, s, o = _conv_inputs(11, (1, 8, 8, 8), 5, 5)
        expect = ref_conv_kernel.dilated_conv3d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=2,
            scale=jnp.asarray(s), offset=jnp.asarray(o), fuse_affine=True,
            block=8, interpret=True,
        )
        got = ops.dilated_conv3d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), dilation=2,
            scale=torch.from_numpy(s), offset=torch.from_numpy(o), fuse_affine=True,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=KERNEL_ATOL)

    def test_views_variant_against_pallas_k5_interpret(self):
        # K5's TPU kernel, the 27-view schedule, one fused layer at 8^3,
        # block 8, in interpret mode; the port's variant="views" on the CPU.
        x, w, b, s, o = _conv_inputs(12, (1, 8, 8, 8), 5, 5)
        expect = ref_conv_kernel.dilated_conv3d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=4,
            scale=jnp.asarray(s), offset=jnp.asarray(o), fuse_affine=True,
            block=8, interpret=True, variant="views",
        )
        before = (conv_kernel.launches, conv_kernel.views_launches)
        got = conv_kernel.dilated_conv3d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), dilation=4,
            scale=torch.from_numpy(s), offset=torch.from_numpy(o), fuse_affine=True, variant="views",
        )
        assert (conv_kernel.launches, conv_kernel.views_launches) == before
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=KERNEL_ATOL)
        with pytest.raises(ValueError, match="variant"):
            conv_kernel.dilated_conv3d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), variant="rows")

    def test_views_stage_one_tile_beside_the_weights(self):
        # K5 stages an (8, 8, 8, Cin) input tile too: 91 KB at 21 -> 21
        assert conv_kernel.smem_bytes(21, 21, "views") == (27 * 21 * 21 + 3 * 21 + 512 * 21) * 4
        assert conv_kernel.smem_bytes(21, 21, "views") < conv_kernel.SMEM_LIMIT

    def test_four_dim_input_gets_a_channel(self):
        x, w, b, _, _ = _conv_inputs(2, ODD_SHAPE, 1, 5)
        t = torch.from_numpy(x)
        got = ops.dilated_conv3d(t[..., 0], torch.from_numpy(w), torch.from_numpy(b), dilation=2)
        assert torch.equal(got, ops.dilated_conv3d(t, torch.from_numpy(w), torch.from_numpy(b), dilation=2))

    @pytest.mark.parametrize(
        "xs,ws,bs,dilation",
        [
            ((1, 4, 4, 4), (3, 3, 3, 5, 5), (5,), 1),  # no channel axis
            ((1, 4, 4, 4, 5), (3, 3, 3, 4, 5), (5,), 1),  # Cin mismatch
            ((1, 4, 4, 4, 5), (1, 1, 1, 5, 5), (5,), 1),  # not 3x3x3
            ((1, 4, 4, 4, 5), (3, 3, 3, 5, 5), (4,), 1),  # bias width
            ((1, 4, 4, 4, 5), (3, 3, 3, 5, 5), (5,), 0),  # dilation < 1
        ],
    )
    def test_wrapper_rejects_what_the_kernel_does_not_take(self, xs, ws, bs, dilation):
        with pytest.raises(ValueError):
            conv_kernel.dilated_conv3d(
                torch.zeros(xs), torch.zeros(ws), torch.zeros(bs), dilation=dilation
            )

    def test_weights_fit_one_block_of_shared_memory(self):
        # the widest hidden layer (21 -> 21): 53.2 KB of weights at row
        # stride 24, bias, scale and offset (63 -> 64 floats), and 4 warps'
        # rings of 2 slots, each ceil4(160 x 21) + 4 floats (R = 4)
        assert conv_kernel.smem_bytes(21, 21) == (27 * 21 * 24 + 64 + 4 * 2 * (160 * 21 + 4)) * 4
        assert conv_kernel.smem_bytes(21, 21) < conv_kernel.SMEM_LIMIT
        assert conv_kernel.smem_bytes(128, 21) > conv_kernel.SMEM_LIMIT

    @pytest.mark.parametrize(
        "cin,cout,warps,wb,floats",
        [
            # weights 27 Cin CP (CP = Cout rounded up to 4), bias, scale and
            # offset (3 Cout rounded up to 4), then warps x 2 slots of
            # ceil4(WB (Cin | 1)) + 4 floats, WB = 32 R + 32
            (1, 5, 4, 288, 27 * 1 * 8 + 16 + 4 * 2 * (288 + 4)),  # 10,272 bytes
            (5, 5, 4, 288, 27 * 5 * 8 + 16 + 4 * 2 * (1440 + 4)),  # 50,592 bytes
            (5, 10, 4, 160, 27 * 5 * 12 + 32 + 4 * 2 * (800 + 4)),  # R = 4 from C = 10
            (10, 10, 4, 160, 27 * 10 * 12 + 32 + 4 * 2 * (1760 + 4)),  # even Cin: stride 11
            (18, 18, 4, 160, 27 * 18 * 20 + 56 + 4 * 2 * (3040 + 4)),
            # 64 -> 21: one warp, and the box shrinks to what is left
            (64, 21, 1, 127, 27 * 64 * 24 + 64 + 2 * (127 * 65 + 1 + 4)),
        ],
    )
    def test_k1_layout_is_hand_counted(self, cin, cout, warps, wb, floats):
        assert conv_kernel.k1_layout(cin, cout) == (warps, wb, floats)
        assert conv_kernel.smem_bytes(cin, cout) == 4 * floats <= conv_kernel.SMEM_LIMIT
        assert conv_kernel.voxels_per_lane(cout) == (8 if cout <= 5 else 4)
        assert conv_kernel.rows_per_warp(cout) == (2 if cout <= 10 else 1)


class TestReducedLayout:
    """K1r's tile and shared memory (``lp_tile``, ``lp_layout``, the Python
    mirror of csrc/dilated_conv3d_lp.cu that the card tests hold to the
    library), the rows it stages, and what its wrapper refuses."""

    @pytest.mark.parametrize(
        "cin,cout,d,tile,raw,total",
        [
            # params: zero group 16, B fragments 9 tap rows x 2 k16 steps x
            # 1 n8 tile x 256, table 16, bias/scale/offset 64, 4 mbarriers
            # 32 -> rows at 4736; 24 staged rows of 66 positions x 16 bytes;
            # raw 24 x 16 Cin (ceil(66 / 8) + 1) groups; 8 output rows of
            # ceil16(64 x 5 x 2) + 32 = 672 bytes
            (5, 5, 1, (4, 2, 4), 4736 + 24 * 66 * 16, 4736 + 24 * 66 * 16 + 24 * 800 + 8 * 672),  # 54,656
            (1, 5, 1, (4, 2, 4), 4736 + 24 * 66 * 16, 4736 + 24 * 66 * 16 + 24 * 160 + 8 * 672),  # 39,296
            # d = 16: rows of 64 + 32 positions, 13 groups a raw row
            (5, 5, 16, (4, 2, 4), 4736 + 24 * 96 * 16, 4736 + 24 * 96 * 16 + 24 * 1040 + 8 * 672),  # 71,936
            # d = 70 > 64 voxels: three windows of 64 positions a row, 3 x 9 groups
            (5, 5, 70, (4, 2, 4), 4736 + 24 * 192 * 16, 4736 + 24 * 192 * 16 + 24 * 2160 + 8 * 672),
            # 64 -> 21 at d = 40: 12 k16 steps x 3 n8 tiles of fragments; 4 and
            # 2 warps do not fit, 1 warp of 4 rows x 16 voxels does; 144-byte
            # positions (9 groups), no raw buffer (cp.async straight in)
            (64, 21, 40, (1, 4, 1), 83344 + 18 * 48 * 144, 83344 + 18 * 48 * 144 + 4 * 704),  # 210,576
        ],
    )
    def test_k1r_layout_is_hand_counted(self, cin, cout, d, tile, raw, total):
        assert conv_kernel.lp_tile(cin, cout, d) == tile
        layout = conv_kernel.lp_layout(cin, cout, d, tile)
        assert (layout.raw, layout.total) == (raw, total)
        assert conv_kernel.lp_smem_bytes(cin, cout, d) == total <= conv_kernel.SMEM_LIMIT
        assert layout.rows % 16 == layout.raw % 16 == layout.obuf % 16 == 0
        assert conv_kernel.lp_blocking(cout) == {5: (2, 4), 21: (4, 1)}[cout]

    @pytest.mark.parametrize("cout", [5, 10, 18, 21])
    def test_k1r_every_case_fits(self, cout):
        # every case phase 9a and the card tests launch has a tile that fits
        # one block; the narrowest tiles only where Cin = 64 needs them
        for cin, d in itertools.product((1, 5, 64), (1, 2, 3, 4, 8, 16, 40)):
            tile = conv_kernel.lp_tile(cin, cout, d)
            assert tile is not None, (cin, d)
            assert conv_kernel.lp_smem_bytes(cin, cout, d) <= conv_kernel.SMEM_LIMIT
            if cin < 64:
                assert tile == (4,) + conv_kernel.lp_blocking(cout), (cin, d, tile)
        # gwm_light's layers keep at least 3 blocks an SM at 128 registers
        for d in (1, 2, 4, 8, 16):
            assert conv_kernel.lp_blocks_per_sm_model(5, 5, d, 128) >= 3
        assert conv_kernel.lp_blocks_per_sm_model(5, 5, 1, 128) == 4  # registers and shared memory alike

    def test_k1r_stages_each_row_about_three_times(self):
        # gwm_light at 256^3: per tile (4 z rows x 2 y rows x 64 voxels) the
        # 6 x 4 input rows it reads, those in the volume. d = 1: 64 z groups
        # read 6 planes but the first and last 5 (382), 128 y groups 4 rows
        # but 2 (510), 4 x chunks
        shape = (1, 256, 256, 256)
        assert conv_kernel.lp_staged_rows(shape, 5, 5, 1) == 382 * 510 * 4
        assert conv_kernel.lp_tile_count(shape, 5, 5, 1) == 64 * 128 * 4
        out_rows = 256 * 256
        cfg = meshnet.PAPER_MODELS["gwm_light"]
        cin = cfg.in_channels
        for d in cfg.dilations:
            tiles_x = 256 // 64
            per_out_row = conv_kernel.lp_staged_rows(shape, cin, cfg.channels, d) / (out_rows * tiles_x)
            # each output row's span: 2.58 (d = 16) to 2.97 (d = 1) copies,
            # against 9 input-row loads an output row in the first K1r
            # (each tap its own load) and 3 (M + 2) / M = 6 in K2r's
            # per-warp streaming (M = 2 rows an item)
            assert 2.5 < per_out_row < 3.0, (d, per_out_row)
            cin = cfg.channels

    def test_k1r_wrapper_refuses_what_the_kernel_does_not_take(self):
        x = torch.zeros((1, 8, 8, 8, 5), dtype=torch.bfloat16)
        w = torch.zeros((3, 3, 3, 5, 5), dtype=torch.bfloat16)
        b = torch.zeros(5)
        check = conv_kernel.lp_check
        assert check(x, w, b, 1, None, None, False) == (None, None)
        scale, offset = check(x, w, b, 1, None, None, True)
        assert torch.equal(scale, torch.ones(5)) and torch.equal(offset, torch.zeros(5))
        with pytest.raises(TypeError, match="bfloat16 or int8"):
            check(x, w.float(), b, 1, None, None, False)
        with pytest.raises(TypeError, match="float32 bias"):
            check(x, w, b.to(torch.bfloat16), 1, None, None, False)
        with pytest.raises(ValueError, match="contiguous"):
            check(x.transpose(1, 2), w, b, 1, None, None, False)
        with pytest.raises(ValueError, match="Cout=3"):
            check(x, w[..., :3].contiguous(), b[:3], 1, None, None, False)
        x256 = torch.zeros((1, 4, 4, 4, 256), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="shared memory"):
            check(x256, torch.zeros((3, 3, 3, 256, 21), dtype=torch.int8), torch.zeros(21), 1, None, None, False)
        assert conv_kernel.lp_tile(256, 21, 1) is None


class TestFusedForward:
    """ops.meshnet_apply (the cuda_fused backend, plain path on the CPU)
    against the reference's oracle, repro.core.meshnet.apply."""

    @pytest.mark.parametrize("name", sorted(ref_meshnet.PAPER_MODELS))
    def test_paper_models(self, name):
        ref_cfg = dataclasses.replace(ref_meshnet.PAPER_MODELS[name], dilations=(1, 2, 4))
        self._parity(ref_cfg, ODD_SHAPE, seed=3)

    def test_no_batchnorm(self):
        self._parity(ref_meshnet.MeshNetConfig(dilations=(1, 2, 4), use_batchnorm=False), ODD_SHAPE, seed=4)

    def test_full_schedule_batched_odd(self):
        self._parity(ref_meshnet.MeshNetConfig(), (2, 9, 17, 13), seed=5)

    def _parity(self, ref_cfg, shape, seed):
        tree = _np_params(ref_cfg, seed)
        x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
        expect = ref_meshnet.apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), ref_cfg)
        got = executors.apply(
            "cuda_fused", bridge.params_from_numpy(tree, "cpu"), torch.from_numpy(x), _port_cfg(ref_cfg)
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=FUSED_ATOL)

    def test_fold_batchnorm_matches_reference(self):
        from repro.kernels import ops as ref_ops

        layer = _np_params(ref_meshnet.MeshNetConfig(dilations=(1,)), seed=6)["layers"][0]
        expect = ref_ops.fold_batchnorm(jax.tree.map(jnp.asarray, layer))
        got = ops.fold_batchnorm(bridge.params_from_numpy(layer, "cpu"))
        for g, e in zip(got, expect):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6)


class TestPrecisionPolicy:
    def test_auto_is_fp32_and_reduced_precisions_wait(self):
        # "auto" stays fp32 on every device (quantize.resolve_precision says
        # why); the explicit reduced names validate and resolve to themselves
        assert quantize.resolve_precision(None) == "fp32"
        assert quantize.resolve_precision("auto", meshnet.PAPER_MODELS["atlas_104"]) == "fp32"
        for name in ("bf16", "int8w"):
            assert quantize.resolve_precision(name) == quantize.validate(name) == name
        with pytest.raises(ValueError, match="unknown precision"):
            quantize.validate("fp8")
        assert [quantize.act_bytes(p) for p in quantize.PRECISIONS] == [4, 2, 2]

    @pytest.mark.parametrize("name", sorted(ref_meshnet.PAPER_MODELS))
    def test_model_params_bytes_matches_reference(self, name):
        from repro.kernels import quantize as ref_quantize

        cfg = meshnet.PAPER_MODELS[name]
        expect = ref_quantize.model_params_bytes(ref_meshnet.PAPER_MODELS[name], "fp32")
        assert quantize.model_params_bytes(cfg, "fp32") == expect
        tree = _np_params(cfg, seed=0)
        assert expect == sum(a.nbytes for a in jax.tree.leaves(tree))
