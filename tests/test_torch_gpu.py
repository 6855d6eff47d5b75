"""K1-K5, K1r, K2r and K2z and their paths on the CUDA card (the sharded
executors on one card's device list included), against their plain versions
on the same card (and a train step and LM decoding against the CPU), and
queued serving through the request scheduler. Marked ``gpu``: without a
card every test skips (the fixture decides, at run time), but the one that
pins the bf16 gate's step, which needs no card. Run on a machine with an
H100:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports torch only, so it runs where jax is not installed."""

import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.core import executors, meshnet, pipeline
from repro_torch.data import mri
from repro_torch.kernels import decode_attention as k4
from repro_torch.kernels import dice as dice_kernel
from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops, ref
from repro_torch.models import model as lm
from repro_torch.serving.engine import LMEngine, Request
from repro_torch.training import optimizer, trainer

pytestmark = pytest.mark.gpu

REL_TOL = 5e-5  # per-kernel fp32 bound, relative to the output's largest magnitude


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shape, cin, cout, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape + (cin,), generator=g)
    w = torch.randn((3, 3, 3, cin, cout), generator=g) * 0.2
    b = torch.randn(cout, generator=g) * 0.1
    s = 0.5 + torch.rand(cout, generator=g)
    o = torch.randn(cout, generator=g) * 0.1
    return [t.to(device) for t in (x, w, b, s, o)]


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("cin,cout", [(1, 5), (5, 5), (5, 10), (18, 18), (21, 21)])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
def test_kernel_matches_plain_version(cuda, dilation, cin, cout, affine):
    x, w, b, s, o = _inputs(dilation + cin, (2, 19, 24, 21), cin, cout, cuda)
    kw = dict(dilation=dilation, scale=s, offset=o, fuse_affine=affine)
    before = conv_kernel.launches
    got = conv_kernel.dilated_conv3d(x, w, b, **kw)
    torch.cuda.synchronize()
    assert conv_kernel.launches == before + 1
    expect = ref.dilated_conv3d(x, w, b, **kw)
    err = float((got - expect).abs().max()) / float(expect.abs().max())
    assert err <= REL_TOL, err


@pytest.mark.parametrize("dilation", [1, 3, 16])
@pytest.mark.parametrize("cin", [1, 5, 64])
@pytest.mark.parametrize("cout", [5, 10, 18, 21])
def test_kernel_every_width_at_the_odd_shape(cuda, cout, cin, dilation):
    """K1 on the conv tile core at every instantiated width with Cin 1, 5
    and 64 (64 -> 21 shrinks the block to fewer warps), batch 2 at the odd
    shape (10, 12, 14); d = 16 is past every extent, so only the centre
    tap is inside the volume."""
    x, w, b, s, o = _inputs(cout * 100 + cin + dilation, (2, 10, 12, 14), cin, cout, cuda)
    kw = dict(dilation=dilation, scale=s, offset=o, fuse_affine=True)
    got = conv_kernel.dilated_conv3d(x, w, b, **kw)
    torch.cuda.synchronize()
    expect = ref.dilated_conv3d(x, w, b, **kw)
    assert float((got - expect).abs().max()) <= REL_TOL * float(expect.abs().max())


@pytest.mark.parametrize(
    "shape,cin,cout,dilation",
    [
        ((1, 4, 5, 300), 5, 5, 1),  # two chunks of 256 voxels a row, the second ragged
        ((1, 3, 6, 530), 1, 5, 7),
        ((1, 4, 3, 200), 5, 10, 40),  # d > 16: narrower chunks, three windows apart at d >= t_x
        ((2, 3, 4, 150), 21, 21, 150),
        ((1, 9, 7, 5), 64, 21, 2),
    ],
)
def test_kernel_chunks_and_wide_dilations(cuda, shape, cin, cout, dilation):
    x, w, b, s, o = _inputs(shape[-1] + dilation, shape, cin, cout, cuda)
    for fuse in (False, True):
        kw = dict(dilation=dilation, scale=s, offset=o, fuse_affine=fuse)
        got = conv_kernel.dilated_conv3d(x, w, b, **kw)
        torch.cuda.synchronize()
        expect = ref.dilated_conv3d(x, w, b, **kw)
        assert float((got - expect).abs().max()) <= REL_TOL * float(expect.abs().max())


def test_kernel_layout_is_the_wrappers(cuda):
    """smem_bytes mirrors the layout K1 allocates (csrc/dilated_conv3d.cu)."""
    lib = conv_kernel._kernel("halo")[0]
    for cin, cout in itertools.product((1, 2, 5, 10, 18, 21, 33, 64, 100, 128), (5, 10, 18, 21)):
        assert lib.repro_dilated_conv3d_smem_bytes(cin, cout) == conv_kernel.smem_bytes(cin, cout), (cin, cout)


def test_ptxas_reports_no_spills(cuda):
    """K1's, K2's and K2r's every instantiated width fits its registers."""
    from repro_torch.kernels import _build

    _build.build_all(["dilated_conv3d", "megakernel", "megakernel_lp"])
    for name in ("dilated_conv3d", "megakernel", "megakernel_lp"):
        report = [line for line in _build.build_log(name).splitlines() if "spill" in line]
        assert len(report) >= 4 and all("0 bytes spill stores, 0 bytes spill loads" in line for line in report), report


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, b, _, _ = _inputs(0, (1, 8, 8, 8), 5, 5, cuda)
    with pytest.raises(TypeError):
        conv_kernel.dilated_conv3d(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv_kernel.dilated_conv3d(x.transpose(1, 2), w, b)
    x3, w3, b3, _, _ = _inputs(0, (1, 8, 8, 8), 5, 3, cuda)
    with pytest.raises(ValueError, match="Cout=3"):
        conv_kernel.dilated_conv3d(x3, w3, b3)


def test_fused_forward_matches_plain_forward(cuda):
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = meshnet.init(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    x = torch.rand((1, 40, 48, 36), generator=torch.Generator().manual_seed(2)).to(cuda)
    before = conv_kernel.launches
    got = executors.apply("cuda_fused", params, x, cfg)
    assert conv_kernel.launches == before + len(cfg.dilations)
    expect = executors.apply("torch", params, x, cfg)
    err = float((got - expect).abs().max()) / float(expect.abs().max())
    assert err <= 2e-4, err


def test_pipeline_on_the_card_uses_the_kernel(cuda):
    cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
    params = meshnet.init(cfg, generator=torch.Generator().manual_seed(3), device=cuda)
    vol = np.random.default_rng(4).random((30, 32, 28)).astype(np.float32)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=(32, 32, 32), min_component_size=4)
    before = conv_kernel.launches
    res = pipeline.run(pc, params, vol)
    assert res.record.status == "ok" and res.record.executor == "cuda_fused"
    assert conv_kernel.launches == before + 3
    assert res.segmentation.device.type == "cuda" and res.segmentation.shape == (32, 32, 32)


def _params_with_bn(cfg, seed, device):
    g = torch.Generator().manual_seed(seed)
    params = meshnet.init(cfg, generator=g, device="cpu")
    for layer in params["layers"]:
        c = layer["b"].shape[0]
        layer["b"] = 0.1 * torch.randn(c, generator=g)
        layer["bn_scale"] = 1.0 + 0.2 * torch.randn(c, generator=g)
        layer["bn_bias"] = 0.1 * torch.randn(c, generator=g)
        layer["bn_mean"] = 0.3 * torch.randn(c, generator=g)
        layer["bn_var"] = 0.5 + torch.rand(c, generator=g)
    return {
        "layers": [{k: t.to(device) for k, t in layer.items()} for layer in params["layers"]],
        "head": {k: t.to(device) for k, t in params["head"].items()},
    }


def _written(pln, i):
    o = pln.out_halo(i)
    return (slice(None),) + tuple(slice(o, o + p) for p in pln.padded(pln.segments[i])) + (slice(None),)


@pytest.mark.parametrize(
    "channels,classes,dilations,shape,budget",
    [
        (5, 3, (1, 2, 4, 8, 16, 8, 4, 2, 1), (1, 40, 36, 44), mk.SMEM_BUDGET),
        (5, 2, (1, 1, 2, 1), (2, 30, 26, 29), mk.SMEM_BUDGET),
        (10, 2, (1, 2, 4, 8), (1, 33, 20, 27), 60_000),
        (10, 50, (2, 1, 1), (2, 19, 24, 21), mk.SMEM_BUDGET),
        (18, 104, (1, 2, 1), (1, 20, 20, 20), 100_000),
        (21, 3, (1, 2, 4, 2, 1), (2, 19, 24, 21), 120_000),
        # the odd shape, batch 2, plans forced to several segments
        (5, 3, (1, 2, 4, 8, 16, 8, 4, 2, 1), (2, 10, 12, 14), 40_000),
        (5, 3, (1, 2, 4, 8, 16, 8, 4, 2, 1), (2, 10, 12, 14), 20_000),
        (10, 3, (1, 2, 4, 2, 1), (2, 10, 12, 14), 60_000),
        (18, 104, (3, 1), (2, 10, 12, 14), mk.SMEM_BUDGET),
        # rows longer than a warp's chunk, and a dilation past the extent
        (5, 2, (1, 2, 1), (1, 6, 5, 300), mk.SMEM_BUDGET),
        (21, 3, (16, 1), (1, 9, 10, 11), mk.SMEM_BUDGET),
    ],
)
def test_megakernel_segments_match_plain_version(cuda, channels, classes, dilations, shape, budget):
    # every segment on the same staging array, its border filled with NaN
    cfg = meshnet.MeshNetConfig(channels=channels, num_classes=classes, dilations=dilations)
    params = _params_with_bn(cfg, channels + classes, cuda)
    pln = mk.plan_for_config(cfg, shape[1:], smem_budget=budget, batch=shape[0])
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    h = pln.segments[0].halo
    act = torch.full((shape[0],) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (1,), float("nan"), device=cuda)
    act[:, h : h + shape[1], h : h + shape[2], h : h + shape[3], 0] = x
    for i, seg in enumerate(pln.segments):
        operands = ops.megakernel_operands(params, cfg, seg)
        before = mk.launches
        out = mk.run_segment(act, pln, i, *operands)
        torch.cuda.synchronize()
        assert mk.launches == before + 1
        w = _written(pln, i)
        got, expect = out[w], ref.megakernel_segment(act, pln, i, *operands)[w]
        assert torch.isfinite(got).all()
        err = float((got - expect).abs().max()) / float(expect.abs().max())
        assert err <= REL_TOL, (i, seg, err)
        act = torch.full_like(out, float("nan"))
        act[w] = out[w]


@pytest.mark.parametrize("budget", [mk.SMEM_BUDGET, 200_000])
def test_megakernel_takes_a_64_channel_input(cuda, budget):
    """A 64-channel first layer (the planner's widest case) through K2,
    segment by segment with NaN borders."""
    cfg = meshnet.MeshNetConfig(in_channels=64, channels=21, num_classes=3, dilations=(1, 2))
    params = _params_with_bn(cfg, 64, cuda)
    shape = (2, 10, 12, 14)
    pln = mk.plan_for_config(cfg, shape[1:], smem_budget=budget, batch=2)
    x = torch.rand(shape + (64,), generator=torch.Generator().manual_seed(6)).to(cuda)
    h = pln.segments[0].halo
    act = torch.full((2,) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (64,), float("nan"), device=cuda)
    act[:, h : h + shape[1], h : h + shape[2], h : h + shape[3]] = x
    for i, seg in enumerate(pln.segments):
        operands = ops.megakernel_operands(params, cfg, seg)
        out = mk.run_segment(act, pln, i, *operands)
        torch.cuda.synchronize()
        w = _written(pln, i)
        got, expect = out[w], ref.megakernel_segment(act, pln, i, *operands)[w]
        assert torch.isfinite(got).all()
        assert float((got - expect).abs().max()) <= REL_TOL * float(expect.abs().max()), (i, seg)
        act = torch.full_like(out, float("nan"))
        act[w] = out[w]


@pytest.mark.parametrize("channels", [5, 10, 18, 21])
def test_planner_occupancy_is_the_runtimes(cuda, channels):
    """The planner's blocks an SM (shared memory, threads and its register
    table) equal the occupancy calculator's for the built K2."""
    cfg = meshnet.MeshNetConfig(channels=channels, num_classes=3)
    segs = list(mk.plan_for_config(cfg, (256, 256, 256)).segments)
    segs += [mk.Segment(1, (2,), channels, channels, t) for t in ((2, 2, 2), (8, 8, 64), (4, 4, 256))]
    for seg in segs:
        if mk._segment_smem_bytes(seg) <= mk.SMEM_BUDGET:
            assert mk.blocks_per_sm(seg) == mk._blocks_per_sm(mk._segment_smem_bytes(seg), channels), seg


def test_megakernel_forward_launches_once_a_segment(cuda):
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = _params_with_bn(cfg, 5, cuda)
    x = torch.rand((1, 40, 48, 36), generator=torch.Generator().manual_seed(2)).to(cuda)
    pln = mk.plan_for_config(cfg, (40, 48, 36))
    before = (mk.launches, conv_kernel.launches)
    got = executors.apply("cuda_megakernel", params, x, cfg)
    assert (mk.launches - before[0], conv_kernel.launches - before[1]) == (len(pln.segments), 0)
    expect = executors.apply("torch", params, x, cfg)
    err = float((got - expect).abs().max()) / float(expect.abs().max())
    assert err <= 1e-4, err


def test_megakernel_rejects_what_it_does_not_take(cuda):
    def setup(channels):
        cfg = meshnet.MeshNetConfig(channels=channels, dilations=(1, 2))
        params = _params_with_bn(cfg, 0, cuda)
        pln = mk.plan_for_config(cfg, (8, 8, 8))
        h = pln.segments[0].halo
        x = torch.zeros((1,) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (1,), device=cuda)
        return x, pln, ops.megakernel_operands(params, cfg, pln.segments[0])

    x, pln, (layers, head) = setup(5)
    with pytest.raises(TypeError):
        mk.run_segment(x.double(), pln, 0, layers, head)
    with pytest.raises(ValueError, match="contiguous"):
        mk.run_segment(x.transpose(1, 2), pln, 0, layers, head)
    x3, pln3, (layers3, head3) = setup(3)
    with pytest.raises(ValueError, match="Cout=3"):
        mk.run_segment(x3, pln3, 0, layers3, head3)


def test_pipeline_on_the_card_uses_the_megakernel(cuda):
    cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4))
    params = meshnet.init(cfg, generator=torch.Generator().manual_seed(3), device=cuda)
    vol = np.random.default_rng(4).random((30, 32, 28)).astype(np.float32)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=(32, 32, 32), min_component_size=4, executor="cuda_megakernel")
    before = (mk.launches, conv_kernel.launches)
    res = pipeline.run(pc, params, vol)
    assert res.record.status == "ok" and res.record.executor == "cuda_megakernel"
    segments = len(mk.plan_for_config(cfg, (32, 32, 32)).segments)
    assert (mk.launches - before[0], conv_kernel.launches - before[1]) == (segments, 0)
    assert res.segmentation.device.type == "cuda" and res.segmentation.shape == (32, 32, 32)


def _dice_labels(seed, shape, classes, dtype, device, absent):
    """Labels in [0, C) without class ``absent``; about 2 % are -1, C or
    2^30, which count nowhere."""
    g = torch.Generator().manual_seed(seed)
    lab = torch.randint(0, classes, shape, generator=g)
    lab[lab == absent] = (absent + 1) % classes
    flat = lab.view(-1)
    picks = torch.nonzero(torch.rand(flat.numel(), generator=g) < 0.02)[:, 0]
    flat[picks] = torch.tensor([-1, classes, 2**30])[torch.arange(picks.numel()) % 3]
    return lab.to(dtype).to(device)


@pytest.mark.parametrize(
    "classes,shape,dtypes",
    list(itertools.product(
        (2, 3, 50, 104),
        ((256, 256, 256), (31, 33, 17), (2, 31, 33, 17)),
        ((torch.int32, torch.int32), (torch.int64, torch.int32), (torch.int64, torch.int64)),
    )),
)
def test_dice_counts_match_plain_version(cuda, classes, shape, dtypes):
    pred = _dice_labels(classes, shape, classes, dtypes[0], cuda, absent=classes - 1)
    truth = _dice_labels(classes + 1, shape, classes, dtypes[1], cuda, absent=classes - 1)
    before = dice_kernel.launches
    got = dice_kernel.dice_counts(pred, truth, classes)
    torch.cuda.synchronize()
    assert dice_kernel.launches == before + 1
    expect = ref.dice_counts(pred, truth, classes)
    assert torch.equal(got, expect)
    assert int(got[classes - 1].abs().sum()) == 0
    score, plain = ops.dice(pred, truth, classes), ops.dice_from_counts(expect)
    assert score.view(1).view(torch.int32).item() == plain.view(1).view(torch.int32).item()


def test_dice_counts_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 5, 6), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        dice_kernel.dice_counts(a.float(), a, 3)
    with pytest.raises(ValueError, match="contiguous"):
        dice_kernel.dice_counts(a.transpose(0, 2).contiguous().transpose(0, 2), a, 3)
    with pytest.raises(ValueError, match="no kernel"):
        dice_kernel.dice_counts(a, a.cpu(), 3)
    empty = torch.zeros((0, 3), dtype=torch.int64, device=cuda)
    assert dice_kernel.dice_counts(empty, empty, 2).tolist() == [[0, 0, 0], [0, 0, 0]]


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One gwm_light step at 64^3, batch 2, dropout 0 from the same params
    and batch: loss terms and grad norm within 1e-4 relative, every
    gradient leaf but the pre-BN conv biases (exact gradient 0, rounding
    noise) within 1e-4 of the global norm; the step launches K3 once."""
    cfg = trainer.TrainConfig(
        model=dataclasses.replace(meshnet.PAPER_MODELS["gwm_light"], dropout_rate=0.0),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(64, 64, 64)), batch_size=2),
    )
    params = meshnet.init(cfg.model, generator=torch.Generator().manual_seed(9), device="cpu")
    vol, lab = next(iter(mri.DataLoader(cfg.data, device="cpu")))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = tree.map(lambda t: t.to(dev), params)
        _, _, _, grads = trainer.loss_and_grads(p, vol.to(dev), lab.to(dev), cfg)
        before = dice_kernel.launches
        _, _, metrics = trainer.make_train_step(cfg)(p, optimizer.adamw_init(p, cfg.opt), vol.to(dev), lab.to(dev))
        out[dev.type] = (grads, metrics, dice_kernel.launches - before)
    (cpu_grads, cpu_metrics, cpu_launches), (grads, metrics, launched) = out["cpu"], out["cuda"]
    assert (cpu_launches, launched) == (0, 1)
    for k in ("loss", "ce", "soft_dice_loss", "grad_norm"):
        assert abs(float(metrics[k]) - float(cpu_metrics[k])) <= 1e-4 * abs(float(cpu_metrics[k])), k
    gnorm = float(optimizer.global_norm(cpu_grads))
    for i, (layer, cpu_layer) in enumerate(zip(grads["layers"] + [grads["head"]], cpu_grads["layers"] + [cpu_grads["head"]])):
        for name, g in layer.items():
            if name == "b" and i < len(cfg.model.dilations):
                continue
            assert float((g.cpu() - cpu_layer[name]).abs().max()) <= 1e-4 * gnorm, (i, name)


K4_CASES = [
    (2, 8, 2, 32, 100, 57, torch.float32),  # the reference's four kernel cases
    (1, 4, 4, 16, 64, 63, torch.float32),
    (3, 16, 8, 64, 200, 10, torch.float32),
    (1, 8, 1, 32, 96, 95, torch.float32),
    (2, 8, 4, 32, 80, 40, torch.bfloat16),  # and its bf16 case
    *[(4, 32, 4, 64, 1024, pos, torch.float32) for pos in (0, 1, 511, 512, 1023, 5000)],  # TinyLlama
    (4, 32, 4, 64, 1024, 700, torch.bfloat16),
    (2, 16, 16, 128, 300, 299, torch.float32),  # MHA, hd 128
    (1, 16, 16, 256, 90, 80, torch.float32),  # gemma's hd 256: dynamic shared memory
]


def _k4_inputs(seed, B, H, KV, hd, S, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device, dtype) for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _k4_tol(dtype):
    return 2e-5 if dtype == torch.float32 else 3e-2  # tests/test_kernels.py


@pytest.mark.parametrize("B,H,KV,hd,S,pos,dtype", K4_CASES)
def test_decode_attention_with_pos_on_the_card(cuda, B, H, KV, hd, S, pos, dtype):
    """pos as a (1,) int32 tensor on the card, read by the kernel: the plain
    version's result, and the host int's bit for bit (one launch each)."""
    q, k, v = _k4_inputs(B * S + pos, B, H, KV, hd, S, dtype, cuda)
    pos_dev = torch.full((1,), pos, dtype=torch.int32, device=cuda)
    before = k4.launches
    got = k4.decode_attention(q, k, v, pos_dev)
    host = k4.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert k4.launches == before + 2 and got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, host)
    assert float((got.float() - ref.decode_attention(q, k, v, pos).float()).abs().max()) <= _k4_tol(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_replays_in_a_cuda_graph(cuda, dtype):
    """One capture at TinyLlama's served shape, replayed at 4 positions
    written into the same pos tensor (across the chunk boundaries and past
    the cache): each replay is the plain version's result at that pos."""
    q, k, v = _k4_inputs(21, 4, 32, 4, 64, 1024, dtype, cuda)
    pos_dev = torch.zeros((1,), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: builds the kernel and makes the workspace
        k4.decode_attention(q, k, v, pos_dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k4.decode_attention(q, k, v, pos_dev)
    for pos in (0, 255, 700, 1023, 1500):
        pos_dev.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        err = float((out.float() - ref.decode_attention(q, k, v, pos).float()).abs().max())
        assert err <= _k4_tol(dtype), (pos, err)


#: the child of test_decode_attention_is_one_kernel_a_call: one K4 call a
#: case under torch.profiler, in a process of its own (a profiler session
#: in a process that has run many kernels may see no device event), its
#: {kernel name: count} per case printed as JSON
_K4_PROFILE_CHILD = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import decode_attention as k4

cases = [(4, 32, 4, 64, 1024, 255), (1, 8, 1, 32, 16, 9)]
out = []
for B, H, KV, hd, S, pos in cases:
    g = torch.Generator().manual_seed(22)
    q, k, v = [torch.randn(s, generator=g).cuda() for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    k4.decode_attention(q, k, v, pos)  # warm-up outside the profile: build and workspace
    pos_dev = torch.full((1,), pos, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    for p in (pos, pos_dev):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            k4.decode_attention(q, k, v, p)
            torch.cuda.synchronize()
        out.append({e.key: e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA})
print(json.dumps(out))
"""


def test_decode_attention_is_one_kernel_a_call(cuda):
    """torch.profiler sees exactly one CUDA kernel for each K4 call, with a
    host pos and with a pos on the card, at a split and an unsplit shape.
    The calls are profiled in a fresh process, as ``chip_smoke.py
    --k4-kernels`` does: a profiler session inside a process that has
    already run many kernels (this test after the others) may record no
    device event at all."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    run = subprocess.run([sys.executable, "-c", _K4_PROFILE_CHILD], capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    seen = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(seen) == 4
    for on_card in seen:
        assert len(on_card) == 1 and sum(on_card.values()) == 1 and "decode_attn" in next(iter(on_card)), seen


def test_decode_attention_reuses_its_workspace(cuda):
    """Two calls back to back on one stream, no synchronise between them, at
    two positions: they share the workspace and counters, and each is the
    plain version's result; the counters are back at 0."""
    q, k, v = _k4_inputs(23, 4, 32, 4, 64, 1024, torch.float32, cuda)
    a = k4.decode_attention(q, k, v, 1023)
    n = len(k4._WORKSPACES)
    b = k4.decode_attention(q, k, v, torch.full((1,), 100, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert len(k4._WORKSPACES) == n
    assert float((a - ref.decode_attention(q, k, v, 1023)).abs().max()) <= 2e-5
    assert float((b - ref.decode_attention(q, k, v, 100)).abs().max()) <= 2e-5
    counts = k4._WORKSPACES[(q.device, 4, 4, k4.nsplit(1024, 16), 8, 64)][1]
    assert int(counts.abs().sum()) == 0


@pytest.mark.parametrize(
    "B,H,KV,hd,S,pos,dtype",
    [
        (2, 8, 2, 32, 100, 57, torch.float32),  # the reference's four kernel cases
        (1, 4, 4, 16, 64, 63, torch.float32),
        (3, 16, 8, 64, 200, 10, torch.float32),
        (1, 8, 1, 32, 96, 95, torch.float32),
        (2, 8, 4, 32, 80, 40, torch.bfloat16),  # and its bf16 case
        *[(4, 32, 4, 64, 1024, pos, torch.float32) for pos in (0, 1, 511, 512, 1023, 5000)],  # TinyLlama
        (4, 32, 4, 64, 1024, 700, torch.bfloat16),
        (2, 16, 16, 128, 300, 299, torch.float32),  # MHA, hd 128
        (1, 16, 16, 256, 90, 80, torch.float32),  # gemma's hd 256: dynamic shared memory
    ],
)
def test_decode_attention_matches_plain_version(cuda, B, H, KV, hd, S, pos, dtype):
    g = torch.Generator().manual_seed(B * S + pos)
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype) for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = k4.launches
    got = k4.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert k4.launches == before + 1 and got.dtype == dtype and got.shape == q.shape
    expect = ref.decode_attention(q, k, v, pos)
    tol = 2e-5 if dtype == torch.float32 else 3e-2  # tests/test_kernels.py
    assert float((got.float() - expect.float()).abs().max()) <= tol


def test_decode_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 8, 32), device=cuda)
    k = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(TypeError):
        k4.decode_attention(q.half(), k.half(), k.half(), 3)
    with pytest.raises(TypeError):
        k4.decode_attention(q, k.bfloat16(), k.bfloat16(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        k4.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k, 3)
    with pytest.raises(ValueError, match="no kernel"):
        k4.decode_attention(q, k.cpu(), k, 3)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("cin,cout,shape", [(1, 5, (2, 31, 33, 17)), (5, 5, (2, 31, 33, 17)), (21, 21, (1, 20, 17, 24))])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
def test_views_kernel_is_bit_equal_to_k1(cuda, dilation, cin, cout, shape, affine):
    """K5 against K1 bit for bit (its role as K1's oracle), and against the
    plain version within 5e-5 relative."""
    x, w, b, s, o = _inputs(dilation * 7 + cin, shape, cin, cout, cuda)
    kw = dict(dilation=dilation, scale=s, offset=o, fuse_affine=affine)
    before = (conv_kernel.launches, conv_kernel.views_launches)
    views = conv_kernel.dilated_conv3d(x, w, b, variant="views", **kw)
    halo = conv_kernel.dilated_conv3d(x, w, b, **kw)
    torch.cuda.synchronize()
    assert (conv_kernel.launches, conv_kernel.views_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(views, halo)
    expect = ref.dilated_conv3d(x, w, b, **kw)
    assert float((views - expect).abs().max()) <= REL_TOL * float(expect.abs().max())


def _lm(device):
    cfg = dataclasses.replace(configs.get_smoke("tinyllama-1.1b"), dtype=torch.float32)
    return cfg, lm.init(cfg, generator=torch.Generator().manual_seed(3), device=device)


def test_decode_steps_on_the_card_match_the_cpu(cuda):
    """12 decode steps of the smoke TinyLlama, batch 3: logits within 1e-4
    of the largest logit; one K4 launch a layer a step."""
    cfg, params = _lm("cpu")
    card = tree.map(lambda t: t.to(cuda), params)
    cache, card_cache = lm.init_cache(cfg, 3, 16, device="cpu"), lm.init_cache(cfg, 3, 16, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 12), generator=torch.Generator().manual_seed(4))
    before = k4.launches
    for t in range(12):
        expect, _ = lm.decode_step(params, toks[:, t : t + 1], cache, t, cfg)
        got, _ = lm.decode_step(card, toks[:, t : t + 1].to(cuda), card_cache, t, cfg)
        assert float((got.cpu() - expect).abs().max()) <= 1e-4 * float(expect.abs().max())
    assert k4.launches == before + 12 * cfg.num_layers


def test_lm_engine_on_the_card_matches_the_cpu(cuda):
    """Mixed prompt lengths on 3 slots: the card's greedy tokens are the
    CPU's, and every decode_step launched K4 once a layer."""
    cfg, params = _lm("cpu")
    g = torch.Generator().manual_seed(5)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist(), max_new_tokens=6, id=i)
            for i, n in enumerate((3, 8, 5, 2))]
    expect = LMEngine(params, cfg, slots=3, max_seq=32, prefill_chunk=4, device="cpu").run(reqs)
    eng = LMEngine(tree.map(lambda t: t.to(cuda), params), cfg, slots=3, max_seq=32, prefill_chunk=4, device=cuda)
    before = k4.launches
    got = eng.run(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in expect]
    assert k4.launches - before == eng.steps * cfg.num_layers


# ----------------------------------------------- K1r and the reduced paths ---

def _bf16_step(top):
    """One bf16 step at magnitude ``top``: the spacing of bf16 values in
    its binade [2^e, 2^(e+1)), 2^(e - 7) (chip_smoke.bf16_step)."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("top,step", [(29.88, 0.125), (16.0, 0.125), (15.99, 0.0625), (1.0, 2.0**-7),
                                      (0.75, 2.0**-8), (0.0, 0.0)])
def test_bf16_step_is_the_spacing_at_the_magnitude(top, step):
    """Runs on the CPU too: the gate of the bf16 card tests, one step of
    the binade of the largest magnitude (the F3 case's 29.88: 0.125)."""
    assert _bf16_step(top) == step
    if top > 0:  # the next bf16 value above the binade's base is one step up
        base = torch.tensor(2.0 ** math.floor(math.log2(top)), dtype=torch.bfloat16)
        assert float(torch.nextafter(base, torch.tensor(math.inf, dtype=torch.bfloat16)) - base) == step


def _reduced_inputs(seed, shape, cin, cout, wdtype, device):
    from repro_torch.kernels import quantize

    x, w, b, s, o = _inputs(seed, shape, cin, cout, "cpu")
    x = torch.relu(x).to(torch.bfloat16)  # a layer's input: post-ReLU, bf16
    if wdtype == torch.int8:
        w, wscale = quantize.quantize_symmetric(w)
        s = s * wscale
    else:
        w = w.to(torch.bfloat16)
    return [t.to(device) for t in (x, w, b, s, o)]


@pytest.mark.parametrize("shape", [(2, 10, 12, 14), (2, 9, 11, 72)], ids=["w14", "w72"])
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("dilation", [1, 3, 16, 40])
@pytest.mark.parametrize("cin", [1, 5, 64])
@pytest.mark.parametrize("cout", [5, 10, 18, 21])
def test_reduced_kernel_matches_plain_version(cuda, cout, cin, dilation, wdtype, shape):
    """K1r at every instantiated width with Cin 1, 5 and 64, bf16 or int8
    weights, batch 2 at the odd shape (10, 12, 14), whose rows are not
    16-byte aligned at Cin 1 and 5 (laid out element by element), and at W
    = 72, whose rows are (copied in 16-byte granules) and not a multiple
    of a tile's 64 voxels; d = 16 and 40 are past every extent, and Cin 64
    at d = 40 narrows the tile (one m16 tile along x, fewer warps at C >=
    10). Both round an fp32 sum to bf16, the sums in different orders, so
    one bf16 step at the layer's largest magnitude is the most they may
    differ by."""
    x, w, b, s, o = _reduced_inputs(cout * 100 + cin + dilation + shape[-1] - 14, shape, cin, cout, wdtype, cuda)
    kw = dict(dilation=dilation, scale=s, offset=o, fuse_affine=True)
    before = (conv_kernel.launches, conv_kernel.reduced_launches)
    got = conv_kernel.dilated_conv3d(x, w, b, **kw)
    torch.cuda.synchronize()
    assert (conv_kernel.launches - before[0], conv_kernel.reduced_launches - before[1]) == (0, 1)
    assert got.dtype == torch.bfloat16 and got.shape == shape + (cout,)
    expect = ref.dilated_conv3d(x, w, b, **kw)
    err, gate = float((got.float() - expect.float()).abs().max()), _bf16_step(float(expect.float().abs().max()))
    print(f"max abs error {err}, gate {gate} (largest {float(expect.float().abs().max())})")  # shown by pytest -rP
    assert err <= gate


@pytest.mark.parametrize(
    "shape,cin,cout,dilation",
    [
        ((1, 4, 5, 300), 5, 5, 1),  # five chunks of 64 voxels a row, the last ragged
        ((1, 3, 6, 530), 1, 5, 7),
        ((2, 3, 4, 150), 21, 21, 150),
        ((1, 9, 7, 5), 64, 21, 2),
        ((1, 37, 45, 29), 5, 10, 4),
        ((2, 6, 5, 200), 5, 5, 16),  # 16-byte aligned rows, W not a multiple of 64
        ((1, 5, 6, 100), 64, 5, 40),  # d past the tile's 16 voxels: three windows a row
        ((1, 12, 9, 96), 5, 5, 70),  # three windows of 64 voxels, 16-byte granules
        ((2, 33, 18, 64), 1, 5, 2),  # the first layer's width, two row groups in z and y
    ],
)
def test_reduced_kernel_chunks_and_unfused(cuda, shape, cin, cout, dilation):
    for wdtype in (torch.bfloat16, torch.int8):
        x, w, b, s, o = _reduced_inputs(shape[-1] + dilation, shape, cin, cout, wdtype, cuda)
        for fuse in (False, True):
            kw = dict(dilation=dilation, scale=s, offset=o, fuse_affine=fuse)
            got = conv_kernel.dilated_conv3d(x, w, b, **kw)
            torch.cuda.synchronize()
            expect = ref.dilated_conv3d(x, w, b, **kw)
            assert float((got.float() - expect.float()).abs().max()) <= _bf16_step(float(expect.float().abs().max()))


@pytest.mark.parametrize("cin", [5, 64])
def test_reduced_kernel_unaligned_base(cuda, cin):
    """A contiguous input whose first element is not 16-byte aligned (a
    view at an offset of one element) is laid out element by element."""
    shape = (1, 7, 9, 80)
    x, w, b, s, o = _reduced_inputs(cin, shape, cin, 5, torch.bfloat16, cuda)
    n = x.numel()
    x1 = torch.empty(n + 8, dtype=torch.bfloat16, device=cuda)[1:n + 1].view(x.shape)
    x1.copy_(x)
    assert x1.is_contiguous() and x1.data_ptr() % 16 != 0
    kw = dict(dilation=3, scale=s, offset=o, fuse_affine=True)
    got = conv_kernel.dilated_conv3d(x1, w, b, **kw)
    torch.cuda.synchronize()
    expect = ref.dilated_conv3d(x, w, b, **kw)
    assert float((got.float() - expect.float()).abs().max()) <= _bf16_step(float(expect.float().abs().max()))


def test_reduced_kernel_layout_and_refusals(cuda):
    """The library's tile, shared memory and blocks an SM are the Python
    mirror's (``lp_tile``, ``lp_smem_bytes``, ``lp_blocks_per_sm_model``
    from the kernel's own registers), at every instantiated width, Cin 1, 5,
    21, 64 and 128 and d 1 to 40; no register spills; at least 2 blocks an
    SM for every gwm_light layer at 256^3."""
    lib = conv_kernel._lp_kernel()[0]
    for cin, cout, d in itertools.product((1, 5, 21, 64, 128), (5, 10, 18, 21), (1, 2, 4, 8, 16, 40)):
        assert lib.repro_dilated_conv3d_lp_smem_bytes(cin, cout, d) == conv_kernel.lp_smem_bytes(cin, cout, d)
        assert conv_kernel.lp_library_tile(cin, cout, d) == conv_kernel.lp_tile(cin, cout, d)
        if conv_kernel.lp_tile(cin, cout, d) is None:
            continue  # refused (Cin 128 at the wider widths)
        for w_int8 in (False, True):
            regs, spills = conv_kernel.lp_registers(cin, cout, d, w_int8)
            # the kernel's launch bounds: 4 blocks of 128 threads an SM at C <= 8, else 3
            assert spills == 0 and regs <= (128 if cout <= 8 else 168), (cin, cout, d, regs, spills)
            per_sm = conv_kernel.lp_blocks_per_sm(cin, cout, d, w_int8)
            assert per_sm == conv_kernel.lp_blocks_per_sm_model(cin, cout, d, regs), (cin, cout, d, per_sm)
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    for i, d in enumerate(cfg.dilations):
        cin = cfg.in_channels if i == 0 else cfg.channels
        assert conv_kernel.lp_blocks_per_sm(cin, cfg.channels, d, False) >= 2
    x, w, b, s, o = _reduced_inputs(0, (1, 8, 8, 8), 5, 5, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="bfloat16 or int8"):
        conv_kernel.dilated_conv3d(x, w.float(), b)
    with pytest.raises(TypeError, match="float32 bias"):
        conv_kernel.dilated_conv3d(x, w, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        conv_kernel.dilated_conv3d(x.transpose(1, 2), w, b)
    x3, w3, b3, _, _ = _reduced_inputs(0, (1, 8, 8, 8), 5, 3, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="Cout=3"):
        conv_kernel.dilated_conv3d(x3, w3, b3)
    assert not lib.repro_dilated_conv3d_lp_supports(3)
    xw, ww, bw, _, _ = _reduced_inputs(0, (1, 4, 4, 4), 256, 21, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        conv_kernel.dilated_conv3d(xw, ww, bw)


@pytest.mark.parametrize("name", ["gwm_light", "brain_mask_fast"])
def test_reduced_forwards_hold_the_gates(cuda, name):
    """The reference's gates: bf16 logits within 1e-2 of the plain bf16
    forward and of the fp32 forward; int8w within 2e-2 of the plain int8w
    forward. K1r launched once a layer, K1 never."""
    cfg = meshnet.PAPER_MODELS[name]
    params = meshnet.init(cfg, generator=torch.Generator().manual_seed(7), device=cuda)
    vol, _ = mri.generate(torch.Generator().manual_seed(8), mri.SyntheticMRIConfig(shape=(48, 40, 44)), device=cuda)
    x = vol[None]
    fp32 = executors.apply("torch", params, x, cfg)
    for precision, tol in (("bf16", 1e-2), ("int8w", 2e-2)):
        before = (conv_kernel.launches, conv_kernel.reduced_launches)
        got = executors.apply("cuda_fused", params, x, cfg, precision=precision)
        torch.cuda.synchronize()
        assert (conv_kernel.launches - before[0], conv_kernel.reduced_launches - before[1]) == (0, len(cfg.dilations))
        assert got.dtype == torch.bfloat16
        plain = executors.apply("torch", params, x, cfg, precision=precision)
        assert float((got.float() - plain.float()).abs().max()) <= tol
        if precision == "bf16":
            assert float((got.float() - fp32).abs().max()) <= 1e-2


def test_reduced_streaming_executor_matches_the_plain_forward(cuda):
    cfg = meshnet.MeshNetConfig(dilations=(1, 2, 4, 2, 1))
    params = _params_with_bn(cfg, 9, cuda)
    x = torch.rand((2, 20, 18, 22), generator=torch.Generator().manual_seed(10)).to(cuda)
    got = executors.apply("streaming", params, x, cfg)
    expect = executors.apply("torch", params, x, cfg)
    assert float((got - expect).abs().max()) <= 1e-4 * max(1.0, float(expect.abs().max()))
    for precision, tol in (("bf16", 1e-2), ("int8w", 2e-2)):
        got = executors.apply("streaming", params, x, cfg, precision=precision)
        plain = executors.apply("torch", params, x, cfg, precision=precision)
        assert float((got.float() - plain.float()).abs().max()) <= tol


def test_subvolume_and_reduced_requests_launch_what_they_imply(cuda):
    """Sub-volume mode on the card: K1 exactly 9 x (1 + cubes) a request
    under cuda_fused at fp32 (the mask forward over the whole volume, the
    main one per cube), K2 (mask plan's segments + cubes x the cube plan's)
    under cuda_megakernel; at bf16 and int8w K1r 18 a request, K1 none; an
    engine whose budget forces sub-volume serves (F1)."""
    from repro_torch.serving.engine import SegmentationEngine
    from repro_torch.telemetry.budget import MemoryBudget

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    mcfg = meshnet.PAPER_MODELS["brain_mask_fast"]
    params = _params_with_bn(cfg, 11, cuda)
    mparams = _params_with_bn(mcfg, 12, cuda)
    vol = mri.generate(torch.Generator().manual_seed(13), mri.SyntheticMRIConfig(shape=(48, 48, 48)), device=cuda)[0]
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=(48, 48, 48), use_cropping=True, cube=16, overlap=8,
                                 min_component_size=8)
    engine = SegmentationEngine(params, pc, mask_model=(mparams, mcfg), device=cuda)
    full = engine.submit(vol, mode="full")
    assert full.record.status == "ok"
    ncubes = 27  # the crop is the whole 48^3 volume: (48 / 16)^3 cubes
    assert full.record.crop_size == (48, 48, 48)
    before = (conv_kernel.launches, mk.launches)
    sub = engine.submit(vol, mode="subvolume")
    assert sub.record.status == "ok" and sub.record.mode == "subvolume"
    assert (conv_kernel.launches - before[0], mk.launches - before[1]) == (9 * (1 + ncubes), 0)
    segs = len(mk.plan_for_config(cfg, (32, 32, 32)).segments)
    msegs = len(mk.plan_for_config(mcfg, (48, 48, 48)).segments)
    before = (conv_kernel.launches, mk.launches)
    res = engine.submit(vol, mode="subvolume", executor="cuda_megakernel")
    assert res.record.status == "ok"
    assert (conv_kernel.launches - before[0], mk.launches - before[1]) == (0, msegs + ncubes * segs)
    for precision in ("bf16", "int8w"):
        before = (conv_kernel.launches, conv_kernel.reduced_launches)
        res = engine.submit(vol, precision=precision)
        assert res.record.status == "ok" and res.record.precision == precision
        assert (conv_kernel.launches - before[0], conv_kernel.reduced_launches - before[1]) == (0, 18)
    # K2r at bf16 and int8w: the mask plan's segments + the main plan's a
    # request at the policy, K2 and K1r never
    from repro_torch.kernels import quantize

    for precision in ("bf16", "int8w"):
        segs = sum(len(mk.plan_for_config(c, (48, 48, 48), precision=precision).segments) for c in (cfg, mcfg))
        before = (mk.launches, mk.reduced_launches, conv_kernel.reduced_launches)
        res = engine.submit(vol, precision=precision, executor="cuda_megakernel")
        assert (res.record.status, res.record.executor, res.record.precision) == ("ok", "cuda_megakernel", precision)
        after = (mk.launches, mk.reduced_launches, conv_kernel.reduced_launches)
        assert tuple(a - b for a, b in zip(after, before)) == (0, segs, 0)
        assert quantize.resolve_precision("auto") == "fp32"
    # streaming at 48^3 needs 5.75 MB, a 32^3 cube 1.70 MB (no mask model:
    # its full-volume forward would not fit either)
    tight = SegmentationEngine(params, pc, budget=MemoryBudget(2_000_000), device=cuda)
    assert tight.pick_mode((48, 48, 48)) == "subvolume"
    before = conv_kernel.launches
    res = tight.submit(vol)
    assert res.record.status == "ok" and res.record.mode == "subvolume"
    assert conv_kernel.launches - before == 9 * ncubes
    assert res.segmentation.shape == (48, 48, 48)


# ------------------------------------------------------- queued serving ---


def _queued_engine(cuda):
    from repro_torch.serving.engine import SegmentationEngine

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = _params_with_bn(cfg, 21, cuda)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=(32, 32, 32), min_component_size=8)
    vols = [mri.generate(torch.Generator().manual_seed(22 + i), mri.SyntheticMRIConfig(shape=(32, 32, 32)),
                         device=cuda)[0] for i in range(3)]
    return SegmentationEngine(params, pc, device=cuda), vols


@pytest.mark.parametrize(
    "executor,precision,ran,counter",
    [(None, None, "cuda_fused", "K1"), ("cuda_megakernel", None, "cuda_megakernel", "K2"),
     (None, "bf16", "cuda_fused", "K1r")],
)
def test_drained_requests_equal_submit(cuda, executor, precision, ran, counter):
    """submit_async + drain at 32^3 through the scheduler: each
    segmentation equal to submit's of the same volume, the record stamped
    with the executor that ran, its precision and the scheduler's fields,
    and the kernel launched once a layer (a segment) of each request."""
    engine, vols = _queued_engine(cuda)
    counters = {"K1": lambda: conv_kernel.launches, "K1r": lambda: conv_kernel.reduced_launches,
                "K2": lambda: mk.launches}
    per = (len(mk.plan_for_config(engine.cfg.model, (32, 32, 32)).segments) if counter == "K2"
           else len(engine.cfg.model.dilations))
    ids = [engine.submit_async(v, priority=p, executor=executor, precision=precision)
           for v, p in zip(vols, ["batch", "interactive", "interactive"])]
    before = counters[counter]()
    comps = engine.drain()
    torch.cuda.synchronize()
    assert counters[counter]() - before == per * len(vols)
    assert [c.id for c in comps] == ids
    assert engine.scheduler().stats.batches == 2 and engine.scheduler().stats.conserved()
    for c, v in zip(comps, vols):
        rec = c.record
        assert (c.outcome, rec.status, rec.executor) == ("completed", "ok", ran), rec
        assert rec.precision == (precision or "fp32") and rec.batch_size == (1 if c.id == ids[0] else 2)
        assert rec.queue_wait_s + rec.service_s == pytest.approx(c.finish_s - c.arrival_s)
        expect = engine.submit(v, mode=rec.mode, executor=rec.executor, precision=rec.precision)
        assert torch.equal(c.result.segmentation, expect.segmentation)


def test_a_kernel_that_fails_in_a_drained_request_is_a_permanent_fault(cuda, monkeypatch):
    """A K1 launch that returns an error inside a drained request becomes
    that request's typed permanent_fault, the error's text in its record,
    while the other request (under cuda_megakernel) completes: the fault
    isolation chip_smoke.py's queued phase guards against passing on as a
    served failure."""
    engine, vols = _queued_engine(cuda)
    lib, launch, supports = conv_kernel._kernel("halo")

    def failing(*args):
        return 2  # cudaErrorMemoryAllocation

    monkeypatch.setattr(conv_kernel, "_kernel", lambda variant: (lib, failing, supports))
    bad = engine.submit_async(vols[0])
    good = engine.submit_async(vols[1], executor="cuda_megakernel")
    comps = {c.id: c for c in engine.drain()}
    rec = comps[bad].record
    assert (comps[bad].outcome, rec.status, rec.fail_type) == ("completed", "fail", "permanent_fault")
    assert rec.extra["error"].startswith("RuntimeError: dilated_conv3d (halo) kernel launch failed")
    assert comps[bad].result is None and rec.executor == "cuda_fused"
    assert comps[good].record.status == "ok" and comps[good].result.segmentation is not None
    assert engine.scheduler().stats.permanent_faults == 1


def _launch_counts():
    torch.cuda.synchronize()
    return (conv_kernel.launches, conv_kernel.reduced_launches, mk.launches, mk.reduced_launches)


def test_cache_hit_launches_nothing_and_returns_an_unshared_tensor(cuda):
    """Three identical volumes drained through an ArtifactCache execute
    once (two coalesced), the same volume again completes at admission as
    a hit with no kernel launched, and every segmentation equals submit's
    while no two completions, nor a completion and the cache entry, share
    storage on the card."""
    from repro_torch.serving.cache import ArtifactCache
    from repro_torch.serving.scheduler import SchedulerConfig

    engine, vols = _queued_engine(cuda)
    sched = engine.scheduler(SchedulerConfig(), cache=ArtifactCache())
    for _ in range(3):
        engine.submit_async(vols[0].clone())
    before = _launch_counts()
    comps = engine.drain()
    after = _launch_counts()
    assert after[0] - before[0] == len(engine.cfg.model.dilations)  # one execution under cuda_fused
    assert sorted(c.outcome for c in comps) == ["coalesced", "coalesced", "completed"]
    hit = engine.submit_async(vols[0].clone())
    assert _launch_counts() == after  # answered at admission
    comps += engine.drain()
    assert _launch_counts() == after
    h = next(c for c in comps if c.id == hit)
    assert h.record.cache_hit and h.outcome == "completed" and sched.stats.cache_hits == 1
    assert sched.cache.stats.quarantined_served == 0 and sched.stats.conserved()
    expect = engine.submit(vols[0]).segmentation
    (entry,) = [e for e in sched.cache.entries.values() if e.result is not None]
    segs = [c.result.segmentation for c in comps] + [entry.result.segmentation]
    assert all(s.device.type == "cuda" and torch.equal(s, expect) for s in segs)
    assert len({s.data_ptr() for s in segs}) == len(segs)
    h.result.segmentation.fill_(7)
    assert all(torch.equal(s, expect) for s in segs if s is not h.result.segmentation)


def test_breaker_demotes_k2_to_k1_and_restores(cuda):
    """Injected transient faults on cuda_megakernel (raised before any
    launch) trip the breaker: the next requests serve under cuda_fused
    (K1, no K2); after the fault window and the cooldown one half-open
    probe serves under cuda_megakernel (K2) and closes the breaker. Each
    segmentation equals submit's under the executor that served it."""
    from repro_torch.serving import resilience as rs
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.simulator import VirtualClock

    engine, vols = _queued_engine(cuda)
    clock = VirtualClock(100.0)
    policy = rs.ResiliencePolicy(retry=rs.RetryPolicy(max_attempts=3, backoff_base_s=0.01, seed=0),
                                 breaker=rs.BreakerConfig(trip_after=2, cooldown_s=0.5))
    plan = rs.FaultPlan(seed=0, rules=(rs.FaultRule(kind="transient", rate=1.0, executor_substr="megakernel",
                                                    t0=100.0, t1=101.0),))
    sched = engine.scheduler(SchedulerConfig(max_batch_requests=1), clock=clock, resilience=policy, fault_plan=plan)
    ids = [engine.submit_async(v, executor="cuda_megakernel") for v in vols[:2]]
    before = _launch_counts()
    comps = engine.drain()
    mid = _launch_counts()
    assert [c.record.executor for c in comps] == ["cuda_fused", "cuda_fused"]
    assert mid[2] == before[2] and mid[0] - before[0] == 2 * len(engine.cfg.model.dilations)
    assert [tr["state"] for tr in sched.breaker.transitions] == ["open"]
    assert all(r.extra.get("injected") == "transient" or "injected transient" in r.extra.get("error", "")
               for r in engine.log.records if r.status == "fail")
    clock.advance_to(102.0)  # past the window and the cooldown
    probe = engine.submit_async(vols[2], executor="cuda_megakernel")
    comps += engine.drain()
    end = _launch_counts()
    segments = len(mk.plan_for_config(engine.cfg.model, (32, 32, 32)).segments)
    assert end[2] - mid[2] == segments and end[0] == mid[0]
    assert [tr["state"] for tr in sched.breaker.transitions] == ["open", "half_open", "closed"]
    st = sched.stats
    assert st.faulted_requests == st.recovered_requests and st.retries >= 2 and st.conserved()
    by_id = {c.id: c for c in comps}
    assert by_id[probe].record.executor == "cuda_megakernel"
    for rid, v in zip(ids + [probe], vols):
        rec = by_id[rid].record
        assert rec.status == "ok"
        expect = engine.submit(v, mode=rec.mode, executor=rec.executor).segmentation
        assert torch.equal(by_id[rid].result.segmentation, expect)


def test_breaker_with_k1_faulting_never_serves_a_plain_forward(cuda):
    """Injected transient faults on every CUDA executor (K2's and K1's
    alike) walk the breaker down the card's ladder: cuda_megakernel,
    cuda_fused, then the sub-volume failsafe under cuda_fused, where it
    stops. No attempt runs under the plain forwards (torch, streaming):
    the requests fail with the injected faults, and no kernel launches."""
    from repro_torch.serving import resilience as rs
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.simulator import VirtualClock

    engine, vols = _queued_engine(cuda)
    policy = rs.ResiliencePolicy(retry=rs.RetryPolicy(max_attempts=4, backoff_base_s=0.01, seed=0),
                                 breaker=rs.BreakerConfig(trip_after=1, cooldown_s=1000.0))
    plan = rs.FaultPlan(seed=0, rules=(rs.FaultRule(kind="transient", rate=1.0, executor_substr="cuda_"),))
    sched = engine.scheduler(SchedulerConfig(max_batch_requests=1), clock=VirtualClock(100.0), resilience=policy,
                             fault_plan=plan)
    for v in vols:
        engine.submit_async(v, executor="cuda_megakernel")
    before = _launch_counts()
    comps = engine.drain()
    assert _launch_counts() == before
    tried = [(r.mode, r.executor) for r in engine.log.records]
    assert tried and all(e.startswith("cuda_") for _, e in tried), tried
    assert ("subvolume", "cuda_fused") in tried
    assert all(r.status == "fail" and "injected transient" in r.extra.get("error", "") for r in engine.log.records)
    assert len(comps) == len(vols) and all(c.record.status == "fail" for c in comps)
    assert [tr["rung"] for tr in sched.breaker.transitions][:3] == [1, 2, 3]
    assert sched.stats.conserved()


def test_conform_memo_on_the_card(cuda):
    """Two submits of one volume under PipelineConfig(conform_memo=...):
    one conform, equal segmentations, and the memo's conformed volume on
    the card bit-equal to a fresh conform after both."""
    from repro_torch.core import conform
    from repro_torch.serving.cache import ConformMemo
    from repro_torch.serving.engine import SegmentationEngine

    engine, vols = _queued_engine(cuda)
    memo = ConformMemo()
    engine = SegmentationEngine(engine.params, dataclasses.replace(engine.cfg, conform_memo=memo), device=cuda)
    first, second = engine.submit(vols[0]), engine.submit(vols[0])
    assert (memo.hits, memo.misses) == (1, 1)
    assert torch.equal(first.segmentation, second.segmentation)
    (held,) = memo.entries.values()
    assert held.device.type == "cuda" and torch.equal(held, conform.conform(vols[0], (32, 32, 32)))


# ----------------------------------------------------------------- K2r ---


def _lp_gap(got, expect):
    """(ok, what) of K2r against its plain version: int8 codes within +-1
    and equal at >= 99.9 % of voxels; bf16 within one bf16 step (the
    spacing of bf16 values) at the array's largest magnitude. Both round
    fp32 sums taken in their own orders, so a sum near a rounding boundary
    may land on either side."""
    diff = (got.float() - expect.float()).abs()
    equal = float((diff == 0).float().mean())
    top = float(expect.float().abs().max())
    what = f"max diff {float(diff.max())}, equal {equal}, largest {top}, elements {diff.numel()}"
    if got.dtype == torch.int8:
        return float(diff.max()) <= 1 and equal >= 0.999, what
    return float(diff.max()) <= _bf16_step(top), what


def _poisoned(t, region):
    """A copy of staging array t whose border is poison no code writes:
    -128 for int8 (the codes stop at -127), NaN for bf16 and fp32. A bf16
    or int8 copy has K2r's layout (mk.staging_empty), the pad of each x
    row's pitch poisoned too."""
    poison = -128 if t.dtype == torch.int8 else float("nan")
    if t.dtype == torch.float32:
        out = torch.full_like(t, poison)
    else:
        out = mk.staging_empty(tuple(t.shape), t.dtype, t.device)
        out.as_strided((t.shape[0] * out.stride(0),), (1,)).fill_(poison)
    out[region] = t[region]
    return out


def _reduced_segments(params, cfg, x, pln, precision, scales):
    """Yield (i, staging, operands) for every segment of a reduced plan, the
    first staging the policy's input, each later one K2r's output of the
    segment before; every border poisoned."""
    from repro_torch.kernels import quantize

    first = pln.segments[0]
    h = first.halo
    x = quantize.quantize_input(x) if precision == "int8w" else x.to(torch.bfloat16)
    act = torch.zeros((x.shape[0],) + tuple(p + 2 * h for p in pln.padded(first)) + (x.shape[-1],), dtype=x.dtype,
                      device=x.device)
    act[:, h : h + pln.vol[0], h : h + pln.vol[1], h : h + pln.vol[2]] = x
    act = _poisoned(act, (slice(None),) + tuple(slice(h, h + v) for v in pln.vol) + (slice(None),))
    for i, seg in enumerate(pln.segments):
        layers, head = ops.megakernel_operands(params, cfg, seg, precision)
        deq, qs = mk.scale_operands(pln, i)
        operands = (layers, head, scales[seg.start - 1] if deq else None,
                    scales[seg.start + len(seg.dilations) - 1] if qs else None)
        yield i, act, operands
        act = _poisoned(mk.run_segment(act, pln, i, *operands), _written(pln, i))


@pytest.mark.parametrize("policy", ["bf16", "int8w", "int8w_no_staging", "int8w_every_boundary"])
@pytest.mark.parametrize(
    "channels,classes,dilations,shape,budget,cin",
    [
        (5, 3, (1, 2, 4, 8, 16, 8, 4, 2, 1), (1, 40, 36, 44), mk.SMEM_BUDGET, 1),
        (5, 2, (1, 1, 2, 1), (2, 30, 26, 29), mk.SMEM_BUDGET, 1),
        (10, 2, (1, 2, 4, 8), (1, 33, 20, 27), 60_000, 1),
        (10, 50, (2, 1, 1), (2, 19, 24, 21), mk.SMEM_BUDGET, 1),
        (18, 104, (1, 2, 1), (1, 20, 20, 20), 100_000, 1),
        (21, 3, (1, 2, 4, 2, 1), (2, 19, 24, 21), 120_000, 1),
        # the odd shape, batch 2, plans forced to multi-layer segments
        (5, 3, (1, 2, 4, 8, 16, 8, 4, 2, 1), (2, 10, 12, 14), 40_000, 1),
        (5, 3, (1, 2, 4, 8, 16, 8, 4, 2, 1), (2, 10, 12, 14), 20_000, 1),
        (10, 3, (1, 2, 4, 2, 1), (2, 10, 12, 14), 60_000, 1),
        # rows longer than a warp's chunk, a dilation past the extent, a
        # 64-channel input
        (5, 2, (1, 2, 1), (1, 6, 5, 300), mk.SMEM_BUDGET, 1),
        (21, 3, (16, 1), (1, 9, 10, 11), mk.SMEM_BUDGET, 1),
        (21, 3, (1, 2), (2, 10, 12, 14), 200_000, 64),
    ],
)
def test_reduced_megakernel_segments_match_plain_version(cuda, channels, classes, dilations, shape, budget, cin, policy):
    """K2r segment by segment against its plain version on the same staging
    arrays, their borders and the pads of their x-row pitches poisoned:
    bf16, int8w with int8 staging, int8w without (bf16 staging), and int8w
    with int8 staging at every boundary (every later segment dequantises
    its int8 input: the hi and lo weights of deq); the planner's plans and
    plans forced to multi-layer segments by small budgets."""
    from repro_torch.kernels import quantize

    precision = policy[:5] if policy != "bf16" else "bf16"
    staging = policy in ("int8w", "int8w_every_boundary")
    cfg = meshnet.MeshNetConfig(in_channels=cin, channels=channels, num_classes=classes, dilations=dilations)
    params = quantize.prepare_params(_params_with_bn(cfg, channels + classes, cuda), cfg, precision)
    scales = quantize.staging_scales_from_bn(params, cfg) if staging else None
    pln = mk.plan_for_config(cfg, shape[1:], smem_budget=budget, precision=precision, int8_staging=staging,
                             batch=shape[0])
    if policy == "int8w_every_boundary":
        pln = dataclasses.replace(pln, int8_at=None)
        assert all(mk.scale_operands(pln, i)[0] for i in range(1, len(pln.segments)))
    x = torch.rand(shape + (cin,), generator=torch.Generator().manual_seed(1)).to(cuda)
    for i, act, operands in _reduced_segments(params, cfg, x, pln, precision, scales):
        before = (mk.launches, mk.reduced_launches)
        out = mk.run_segment(act, pln, i, *operands)
        torch.cuda.synchronize()
        assert (mk.launches - before[0], mk.reduced_launches - before[1]) == (0, 1)
        assert out.dtype == pln.dtypes(i)[1]
        w = _written(pln, i)
        got, expect = out[w], ref.megakernel_segment(act, pln, i, *operands)[w]
        if got.dtype == torch.bfloat16:
            assert torch.isfinite(got.float()).all()
        ok, what = _lp_gap(got, expect)
        assert ok, (i, pln.segments[i], what)


@pytest.mark.parametrize("channels", [5, 10, 18, 21])
def test_reduced_planner_occupancy_is_the_runtimes(cuda, channels):
    """The planner's blocks an SM for K2r (its layout and REGISTERS_LP)
    equal the occupancy calculator's for the built K2r, bf16 and int8
    inputs."""
    cfg = meshnet.MeshNetConfig(channels=channels, num_classes=3)
    for precision in ("bf16", "int8w"):
        widths = mk.plan_widths(precision, True)
        segs = list(mk.plan_for_config(cfg, (256, 256, 256), precision=precision).segments)
        segs += [mk.Segment(s, (2,), 1 if s == 0 else channels, channels, t) for s in (0, 1)
                 for t in ((2, 2, 2), (8, 8, 64), (4, 4, 256))]
        for seg in segs:
            smem = mk._segment_smem_bytes(seg, widths)
            if smem <= mk.SMEM_BUDGET:
                assert mk.blocks_per_sm(seg, widths) == mk._blocks_per_sm(smem, channels, widths), (precision, seg)


def test_reduced_megakernel_forward_launches_once_a_segment(cuda, monkeypatch):
    """cuda_megakernel at bf16 and int8w: K2r once a segment, K2 and K1r
    never; the logits within 9b's bf16 gate and the reference's staged
    int8w gate of the same plan's plain version (relative to the largest
    logit)."""
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = _params_with_bn(cfg, 5, cuda)
    x = torch.rand((1, 40, 48, 36), generator=torch.Generator().manual_seed(2)).to(cuda)
    # int8w: a staging code one step off (bound / 127, some 0.05 here) moves
    # the logits downstream of it by more than 9b's 2e-2; the reference's
    # gate for staged forwards, 8e-2 (tests/test_precision.py:114-135)
    for precision, gate in (("bf16", 1e-2), ("int8w", 8e-2)):
        pln = mk.plan_for_config(cfg, (40, 48, 36), precision=precision)
        before = (mk.launches, mk.reduced_launches, conv_kernel.reduced_launches)
        got = executors.apply("cuda_megakernel", params, x, cfg, precision=precision)
        torch.cuda.synchronize()
        after = (mk.launches, mk.reduced_launches, conv_kernel.reduced_launches)
        assert tuple(a - b for a, b in zip(after, before)) == (0, len(pln.segments), 0)
        assert got.dtype == torch.bfloat16 and got.shape == (1, 40, 48, 36, 3)
        with monkeypatch.context() as m:
            m.setattr(mk, "run_segment", lambda *a: ref.megakernel_segment(*a))
            plain = executors.apply("cuda_megakernel", params, x, cfg, precision=precision)
        assert mk.reduced_launches == after[1]
        top = float(plain.float().abs().max())
        assert torch.isfinite(got.float()).all()
        assert float((got.float() - plain.float()).abs().max()) <= gate * top


def test_reduced_megakernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import quantize

    def setup(channels, precision="bf16"):
        cfg = meshnet.MeshNetConfig(channels=channels, dilations=(1, 2))
        params = quantize.prepare_params(_params_with_bn(cfg, 0, cuda), cfg, precision)
        pln = mk.plan_for_config(cfg, (8, 8, 8), precision=precision)
        h = pln.segments[0].halo
        x = torch.zeros((1,) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (1,), dtype=pln.dtypes(0)[0],
                        device=cuda)
        return x, pln, ops.megakernel_operands(params, cfg, pln.segments[0], precision)

    x, pln, (layers, head) = setup(5)
    with pytest.raises(TypeError):
        mk.run_segment(x.float(), pln, 0, layers, head)
    with pytest.raises(ValueError, match="contiguous"):
        mk.run_segment(x.transpose(1, 2), pln, 0, layers, head)
    with pytest.raises(ValueError, match="operands on"):
        mk.run_segment(x, pln, 0, [tuple(t.cpu() for t in layers[0])], head)
    x3, pln3, (layers3, head3) = setup(3)
    with pytest.raises(ValueError, match="Cout=3"):
        mk.run_segment(x3, pln3, 0, layers3, head3)


# ---------------------------------------------- K2z, K2r-z, the sharded family ---


def _junk_outside(t, vol, lo, hi, h):
    """A copy of staging array t (the volume ``vol`` at offset h) with its
    border poisoned and the volume's rows outside [lo, hi) set to junk:
    NaN for fp32 and bf16, 100 for int8, values no bounded kernel may
    read."""
    region = (slice(None),) + tuple(slice(h, h + v) for v in vol) + (slice(None),)
    out = _poisoned(t, region)
    junk = 100 if t.dtype == torch.int8 else float("nan")
    for z in [z for z in range(vol[0]) if not lo <= z < hi]:
        out[:, h + z, h : h + vol[1], h : h + vol[2]] = junk
    return out


def _multi_layer_plan(cfg, vol, widths):
    """gwm_light cut into segments of 2, 1, 1, 1, 2 and 2 layers, each at
    the largest of a few tiles whose layout fits one block: the per-layer
    mask inside a segment acts only where a segment has several layers."""
    segments = []
    for i, j in ((0, 2), (2, 3), (3, 4), (4, 5), (5, 7), (7, 9)):
        for t in ((8, 8, 16), (4, 4, 16), (2, 2, 8)):
            seg = mk.Segment(i, cfg.dilations[i:j], cfg.in_channels if i == 0 else cfg.channels, cfg.channels, t,
                             j == len(cfg.dilations), cfg.num_classes)
            if mk._segment_smem_bytes(seg, widths) <= mk.SMEM_BUDGET:
                segments.append(seg)
                break
    return mk.MegakernelPlan(tuple(segments), vol, widths)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("bounds", [(5, 17), (-3, 9), (12, 40), (0, 23)], ids=["inside", "low", "high", "whole"])
@pytest.mark.parametrize("plan", ["planner", "several_segments", "multi_layer"])
def test_zbounded_segments_match_plain_version(cuda, precision, bounds, plan):
    """K2z (fp32) and K2r-z (bf16, int8w) segment by segment against their
    plain versions with the same bounds, each staging array the bounded
    kernel's output of the segment before, its border poisoned and its
    rows outside the bounds junk: the staged input's mask and, on the
    multi-layer plan, every layer's hold."""
    from repro_torch.kernels import quantize

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    shape = (1, 23, 20, 18)
    params = quantize.prepare_params(_params_with_bn(cfg, 17, cuda), cfg, precision)
    scales = quantize.staging_scales_from_bn(params, cfg) if precision == "int8w" else None
    if plan == "multi_layer":
        pln = _multi_layer_plan(cfg, shape[1:], mk.plan_widths(precision, True))
        assert len(pln.segments) == 6
    else:
        budget = mk.SMEM_BUDGET if plan == "planner" else 40_000
        pln = mk.plan_for_config(cfg, shape[1:], smem_budget=budget, precision=precision)
    x = torch.rand(shape + (1,), generator=torch.Generator().manual_seed(3)).to(cuda)
    x = {"fp32": x, "bf16": x.to(torch.bfloat16), "int8w": quantize.quantize_input(x)}[precision]
    lo, hi = ref.z_interval(shape[1], bounds)
    h = pln.segments[0].halo
    act = torch.zeros((1,) + tuple(p + 2 * h for p in pln.padded(pln.segments[0])) + (1,), dtype=x.dtype, device=cuda)
    act[:, h : h + shape[1], h : h + shape[2], h : h + shape[3]] = x
    for i, seg in enumerate(pln.segments):
        layers, head = ops.megakernel_operands(params, cfg, seg, precision)
        deq, qs = mk.scale_operands(pln, i) if precision != "fp32" else (False, False)
        operands = (layers, head, scales[seg.start - 1] if deq else None,
                    scales[seg.start + len(seg.dilations) - 1] if qs else None)
        act = _junk_outside(act, pln.vol, lo, hi, seg.halo)
        before = (mk.launches, mk.reduced_launches, mk.z_launches)
        out = mk.run_segment(act, pln, i, *operands, z_bounds=bounds)
        torch.cuda.synchronize()
        assert (mk.launches, mk.reduced_launches, mk.z_launches) == (before[0], before[1], before[2] + 1)
        w = _written(pln, i)
        got, expect = out[w], ref.megakernel_segment(act, pln, i, *operands, z_bounds=bounds)[w]
        assert torch.isfinite(got.float()).all()
        if precision == "fp32":
            err = float((got - expect).abs().max()) / float(expect.abs().max())
            assert err <= REL_TOL, (i, err)
        else:
            ok, what = _lp_gap(got, expect)
            assert ok, (i, what)
        act = out


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
def test_whole_volume_bounds_are_bit_equal_to_k2(cuda, precision):
    """K2 (K2r) with bounds of the whole volume, or wider, is bit-equal to
    K2 (K2r) without them: the same kernels, the same interval."""
    from repro_torch.kernels import quantize

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = quantize.prepare_params(_params_with_bn(cfg, 19, cuda), cfg, precision)
    x = torch.rand((1, 40, 36, 44), generator=torch.Generator().manual_seed(4)).to(cuda)
    plain = ops.meshnet_apply_megakernel(params, x, cfg, precision=precision)
    for bounds in [(0, 40), (-7, 90)]:
        got = ops.meshnet_apply_megakernel(params, x, cfg, precision=precision, z_bounds=bounds)
        assert torch.equal(got, plain), bounds


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("inner", ["torch", "cuda_fused", "cuda_megakernel"])
def test_sharded_family_on_one_card(cuda, inner, precision):
    """sharded_<inner> on [cuda:0] * n (n = 2, 4, 8; slabs of 24 to 6 rows,
    thinner than the radius 46) against the single-device inner: 1e-4 at
    fp32 with the segmentation equal, 2e-2 reduced, relative to the
    largest logit; the megakernel inner launches K2z (K2r-z) once a
    segment of each window's plan, and K2 and K2r never."""
    from repro_torch.core import spatial_shard

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = _params_with_bn(cfg, 23, cuda)
    x = torch.rand((1, 48, 40, 36), generator=torch.Generator().manual_seed(5)).to(cuda)
    want = executors.apply(inner, params, x, cfg, precision=precision).float()
    top = float(want.abs().max())
    for n in (2, 4, 8):
        before = (mk.launches, mk.reduced_launches, mk.z_launches)
        got = spatial_shard.sharded_executor_apply(inner, params, x, cfg, precision=precision,
                                                   devices=[cuda] * n).float()
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip((mk.launches, mk.reduced_launches, mk.z_launches), before))
        if inner == "cuda_megakernel":
            window = (48 // n + 2 * sum(cfg.dilations), 40, 36)
            segments = len(mk.plan_for_config(cfg, window, precision=precision).segments)
            assert launched == (0, 0, n * segments), (n, launched)
        else:
            assert launched == (0, 0, 0)
        err = float((got - want).abs().max())
        assert err <= (1e-4 if precision == "fp32" else 2e-2) * top, (n, err, top)
        if precision == "fp32":
            assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
def test_banded_windows_are_bit_equal_on_the_kept_rows(cuda, precision):
    """The sharded megakernel inner's windows (n = 2, 4, 8 slabs of a
    48-row volume) with ``rows`` (each segment only the band its successors
    read; K2z, K2r-z) against the same windows without it: the kept rows
    bit-equal, one launch a segment either way; and the sharded forward
    within 1e-4 (fp32) of the single-device one."""
    from repro_torch.core import spatial_shard
    from repro_torch.kernels import quantize

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = quantize.prepare_params(_params_with_bn(cfg, 31, cuda), cfg, precision)
    x = torch.rand((1, 48, 40, 36, 1), generator=torch.Generator().manual_seed(7)).to(cuda)
    if precision == "int8w":
        x = quantize.quantize_input(x)
    elif precision == "bf16":
        x = x.to(torch.bfloat16)
    radius = sum(cfg.dilations)
    for n in (2, 4, 8):
        dloc = 48 // n
        windows = spatial_shard.halo_exchange_z(list(x.split(dloc, 1)), radius)
        for i, window in enumerate(windows):
            bounds = spatial_shard.window_z_bounds(i, dloc, n, radius)
            segments = len(mk.plan_for_config(cfg, tuple(window.shape[1:4]), precision=precision).segments)
            before = mk.z_launches
            whole = ops.meshnet_apply_megakernel(params, window, cfg, precision=precision, z_bounds=bounds)
            banded = ops.meshnet_apply_megakernel(params, window, cfg, precision=precision, z_bounds=bounds,
                                                  rows=(radius, radius + dloc))
            torch.cuda.synchronize()
            assert mk.z_launches - before == 2 * segments
            assert torch.equal(banded[:, radius : radius + dloc], whole[:, radius : radius + dloc]), (n, i)
    if precision == "fp32":
        want = executors.apply("cuda_megakernel", params, x[..., 0], cfg)
        got = spatial_shard.sharded_executor_apply("cuda_megakernel", params, x[..., 0], cfg, devices=[cuda] * 4)
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_pipeline_shard_devices_on_the_card(cuda):
    """shard_devices=2 on the card: served where the host has 2 cards,
    shard_geometry where it has one."""
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = _params_with_bn(cfg, 29, cuda)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=(32, 32, 32), min_component_size=4,
                                 executor="cuda_megakernel", shard_devices=2)
    vol = torch.rand((32, 32, 32), generator=torch.Generator().manual_seed(6)) * 100
    res = pipeline.run(pc, params, vol)
    assert res.record.executor == "sharded_cuda_megakernel@2"
    if torch.cuda.device_count() >= 2:
        assert res.record.status == "ok", res.record.fail_type
    else:
        assert (res.record.status, res.record.fail_type) == ("fail", "shard_geometry")


# ---------------------------------------------------------------- the fleet ---


def test_executed_fleet_equals_submit_with_exact_launches(cuda):
    """A 2-replica executed fleet at 32^3 under cache_affinity, each
    replica's engine with its own copy of the weights: 4 fp32 requests
    (auto) and 2 under cuda_megakernel in two waves, each segmentation
    equal to submit's on a standalone engine, served once, and K1 and K2
    launched exactly once a layer (a segment) of each record; the second
    wave's fp32 requests land on the replica warm for them."""
    from repro_torch.serving.engine import SegmentationEngine
    from repro_torch.serving.fleet import Fleet, FleetConfig
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = _params_with_bn(cfg, 31, cuda)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=(32, 32, 32), min_component_size=8)

    def factory():
        return SegmentationEngine(tree.map(torch.clone, params), pc, device=cuda)

    fl = Fleet(FleetConfig(replicas=2, execute=True, scheduler=SchedulerConfig(max_batch_requests=4)),
               engine_factory=factory)
    vols = [mri.generate(torch.Generator().manual_seed(32 + i), mri.SyntheticMRIConfig(shape=(32, 32, 32)),
                         device=cuda)[0] for i in range(6)]
    waves = [[(vols[0], None), (vols[1], "cuda_megakernel")],
             [(vols[2], None), (vols[3], None), (vols[4], None), (vols[5], "cuda_megakernel")]]
    asked = {}
    before = _launch_counts()
    for wave in waves:
        for v, ex in wave:
            asked[fl.submit(v, executor=ex)] = (v, ex)
        fl.drain()
    after = _launch_counts()
    segs = len(mk.plan_for_config(cfg, (32, 32, 32)).segments)
    assert after[0] - before[0] == 4 * len(cfg.dilations) and after[2] - before[2] == 2 * segs
    assert after[1] == before[1] and after[3] == before[3]
    assert fl.conserved() and fl.affinity_hits == 4 and fl.cold_compiles == sum(len(r.warm) for r in fl.replicas)
    standalone = factory()
    for e in fl.ledger:
        v, ex = asked[e.fid]
        rec = e.completion.record
        assert (e.completions_seen, e.outcome, rec.status) == (1, "completed", "ok")
        assert rec.executor == (ex or "cuda_fused") and rec.replica_id == e.replica
        expect = standalone.submit(v, mode=rec.mode, executor=rec.executor, precision=rec.precision)
        assert torch.equal(e.completion.result.segmentation, expect.segmentation)
    fused = {e.replica for e in fl.ledger if asked[e.fid][1] is None}
    assert len(fused) == 1  # every fp32 auto request on the replica warm for it
    ptrs = [e.completion.result.segmentation.data_ptr() for e in fl.ledger]
    assert len(set(ptrs)) == len(ptrs)


def test_unet3d_on_the_card_matches_the_cpu(cuda):
    """The U-Net baseline (base 8, 2 levels) at 32^3, batch 2: the card's
    logits within 1e-4 of the CPU forward's on the same weights, relative
    to the largest, TF32 off; argmax agreeing on >= 99.99 %."""
    from repro_torch.core import unet3d

    ucfg = unet3d.UNet3DConfig(base_channels=8, levels=2)
    g = torch.Generator().manual_seed(41)
    params = unet3d.init(ucfg, generator=g, device="cpu")
    x = torch.rand((2, 32, 32, 32), generator=g)
    expect = unet3d.apply(params, x, ucfg)
    got = unet3d.apply(tree.map(lambda t: t.to(cuda), params), x.to(cuda), ucfg).cpu()
    assert float((got - expect).abs().max()) <= 1e-4 * float(expect.abs().max())
    assert float((got.argmax(-1) == expect.argmax(-1)).float().mean()) >= 0.9999
