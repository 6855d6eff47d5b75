"""K1, K2, K3 and their paths on the CUDA card, against their plain
versions on the same card (and one train step against the CPU). Marked
``gpu``: without a card every test skips (the fixture decides, at run
time). Run on a machine with an H100:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports torch only, so it runs where jax is not installed."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import executors, meshnet, pipeline
from repro_torch.data import mri
from repro_torch.kernels import dice as dice_kernel
from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import megakernel as mk
from repro_torch.kernels import ops, ref
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
