"""K1 and the fused forward on the CUDA card, against their plain versions
on the same card. Marked ``gpu``: without a card every test skips (the
fixture decides, at run time). Run on a machine with an H100:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports torch only, so it runs where jax is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.core import executors, meshnet, pipeline
from repro_torch.kernels import dilated_conv3d as conv_kernel
from repro_torch.kernels import ref

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
