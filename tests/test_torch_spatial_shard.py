"""The port's Z-sharded executor family (core/spatial_shard.py) against the
reference on the CPU, the slabs on device lists of the CPU (``["cpu"] *
n``), on inputs made with numpy:

- ``halo_exchange_z`` against a numpy pad-and-slice of the global volume
  at 1, 2, 4 and 8 slabs, halos below, at and above the slab depth
  (multi-hop);
- the composition property of ``tests/test_properties.py`` over fixed
  seeds: per-layer exchanges equal one exchange of the summed halo with
  per-layer re-zeroing, and both equal the unsharded stencil;
- ``sharded_<inner>@n`` for ``torch``, ``cuda_fused`` and
  ``cuda_megakernel`` (their plain CPU paths) at 2, 4 and 8 slabs against
  the reference's single-device inner (``executors.apply(<reference
  inner>)``: the reference's own sharded family raises under this jax,
  ROADMAP rule 7) on perturbed params: logits within 1e-4
  (tests/test_sharded_executor.py) and the segmentation equal, at the
  paper's dilations (radius 46, slabs of 2 to 8: multi-hop); bf16 and
  int8w within 2e-2 (tests/test_precision.py) of the single-device
  inner, the megakernel inner's the port's (the contract) and the
  reference's; at int8w every plan, the windows' too, stages int8 where
  the reference's plan at its shape does;
- the (batch, Z) grid, and ``ShardGeometryError`` for a depth that does
  not divide and for too few devices;
- the registry's sharded names, the byte models against the reference's,
  ``pipeline.run(shard_devices=n)`` and the engine's device counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executors as ref_executors
from repro.core import meshnet as ref_meshnet
from repro.core import pipeline as ref_pipeline
from repro.kernels import megakernel as ref_megakernel
from repro.telemetry import traffic as ref_traffic
from repro_torch import bridge
from repro_torch.core import executors, meshnet, pipeline, spatial_shard
from repro_torch.core.spatial_shard import ShardGeometryError
from repro_torch.kernels import megakernel
from repro_torch.serving.engine import SegmentationEngine
from repro_torch.telemetry import traffic

VOL = (16, 8, 8)  # slabs of 8, 4 and 2: all thinner than the radius 46
SLABS = (2, 4, 8)
ATOL = 1e-4  # tests/test_sharded_executor.py
REDUCED_ATOL = 2e-2  # tests/test_precision.py::TestShardedPrecisionParity
INNERS = {"torch": "xla", "cuda_fused": "pallas_fused", "cuda_megakernel": "pallas_megakernel"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with a test worker on every core, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np_params(cfg, seed):
    """Weights, non-zero biases and BatchNorm statistics, made with numpy:
    with zero biases, out-of-volume activations stay zero by themselves
    and a masking fault at the volume's ends would not show."""
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


def _cfgs(**kw):
    fields = {f.name for f in dataclasses.fields(meshnet.MeshNetConfig)}
    port = meshnet.MeshNetConfig(**kw)
    ref = ref_meshnet.MeshNetConfig(**{k: getattr(port, k) for k in fields})
    return port, ref


def _case(model_kw, seed, shape=(1,) + VOL):
    cfg, ref_cfg = _cfgs(**model_kw)
    params = _np_params(cfg, seed)
    x = np.random.default_rng(seed + 1).random(shape).astype(np.float32)  # a conformed volume's range
    return cfg, ref_cfg, params, bridge.params_from_numpy(params, "cpu"), x


_REFERENCE: dict = {}


def _reference(inner, model, params, x, ref_cfg, precision="fp32"):
    """The reference's single-device inner on the same inputs, once per
    case (its Pallas inners run in interpret mode: seconds)."""
    key = (inner, model, precision, x.shape)
    if key not in _REFERENCE:
        out = ref_executors.apply(inner, params, jnp.asarray(x), ref_cfg, precision=precision)
        _REFERENCE[key] = np.asarray(jnp.asarray(out, jnp.float32))
    return _REFERENCE[key]


def _sharded(inner, port, x, cfg, n, precision="fp32", **kw):
    got = spatial_shard.sharded_executor_apply(
        inner, port, torch.from_numpy(x), cfg, precision=precision, devices=["cpu"] * n, **kw
    )
    return got.float().numpy()


def _cpu_devices(monkeypatch, n):
    """Make the host count ``n`` CPU devices, as the reference's tests
    force XLA's host device count: the default device list, the
    pipeline's pre-flight and the engine's check all read it."""
    monkeypatch.setattr(spatial_shard, "host_devices", lambda kind=None: [torch.device("cpu")] * n)


# --------------------------------------------------------- halo exchange ---


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("halo", [0, 1, 2, 3, 5, 13])
def test_halo_exchange_is_pad_and_slice(n, halo):
    """Slab i's extended slab is rows [i dloc, i dloc + dloc + 2 halo) of
    the global volume zero-padded by ``halo`` in Z: at dloc 2 (8 slabs) a
    halo of 5 crosses three neighbours, the farthest trimmed to one row."""
    x = np.random.default_rng(n * 100 + halo).standard_normal((2, 16, 3, 2, 2)).astype(np.float32)
    dloc = 16 // n
    slabs = list(torch.from_numpy(x).split(dloc, 1))
    got = spatial_shard.halo_exchange_z(slabs, halo)
    padded = np.pad(x, [(0, 0), (halo, halo), (0, 0), (0, 0), (0, 0)])
    assert len(got) == n
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), padded[:, i * dloc : i * dloc + dloc + 2 * halo])


def _valid_tap(y, h):
    """A radius-h two-tap valid stencil: the linear, zero-preserving stand-in
    for a dilated conv layer (it consumes h rows of context a side)."""
    return y[:, : y.shape[1] - 2 * h] + y[:, 2 * h :]


@pytest.mark.parametrize("seed", range(8))
def test_halo_exchange_composes(seed):
    """Per-layer exchanges of h_i equal one exchange of sum(h_i) (multi-hop
    where it passes the slab) provided the one-shot schedule re-zeroes the
    out-of-volume rows after every layer, as K2z's z_bounds do; both equal
    the unsharded 'same'-padded stencil (tests/test_properties.py's
    property, over fixed draws)."""
    rng = np.random.default_rng(seed)
    radii = [int(r) for r in rng.integers(1, 5, size=int(rng.integers(1, 4)))]
    dloc, n = int(rng.integers(1, 5)), int(rng.choice([1, 2, 4, 8]))
    D, total = n * dloc, sum(radii)
    x = torch.from_numpy(rng.standard_normal((1, D, 2, 2, 1)).astype(np.float32))
    slabs = list(x.split(dloc, 1))

    layerwise = slabs
    for h in radii:
        layerwise = [_valid_tap(e, h) for e in spatial_shard.halo_exchange_z(layerwise, h)]
    oneshot = []
    for i, e in enumerate(spatial_shard.halo_exchange_z(slabs, total)):
        cum = 0
        for h in radii:
            e = _valid_tap(e, h)
            cum += h
            g = i * dloc - (total - cum) + torch.arange(e.shape[1])  # global row of local row j
            e = e * ((g >= 0) & (g < D)).view(1, -1, 1, 1, 1)
        oneshot.append(e)
    expect = x
    for h in radii:
        expect = _valid_tap(torch.nn.functional.pad(expect, (0, 0, 0, 0, 0, 0, h, h)), h)
    torch.testing.assert_close(torch.cat(layerwise, 1), expect, atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.cat(oneshot, 1), expect, atol=1e-5, rtol=0)


# ------------------------------------------------------- executor parity ---


@pytest.mark.parametrize("inner", sorted(INNERS))
def test_sharded_inner_matches_reference_single_device(inner):
    """gwm_light at the paper's dilations (radius 46) on 16 x 8 x 8: slabs
    of 8, 4 and 2 rows, so every exchange of the megakernel inner and the
    d = 4..16 exchanges of the layer-wise inners go multi-hop."""
    model = dict(channels=5, num_classes=3)
    cfg, ref_cfg, params, port, x = _case(model, seed=10)
    want = _reference(INNERS[inner], "gwm_light", params, x, ref_cfg)
    for n in SLABS:
        got = _sharded(inner, port, x, cfg, n)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"sharded_{inner}@{n}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize(
    "inner,model",
    [
        ("torch", dict(channels=21, num_classes=3)),  # subvolume_gwm_failsafe
        ("torch", dict(channels=10, num_classes=50)),  # atlas_50
        ("cuda_megakernel", dict(channels=21, num_classes=3)),
        ("cuda_megakernel", dict(channels=5, num_classes=3, use_batchnorm=False)),
        ("cuda_fused", dict(channels=10, num_classes=2, dilations=(1, 2, 4, 2, 1))),
    ],
    ids=["torch_c21", "torch_atlas50", "megakernel_c21", "megakernel_no_bn", "fused_c10"],
)
def test_sharded_other_models_match_reference_xla(inner, model):
    """Wider models and no BatchNorm against the reference's ``xla`` forward
    (the oracle every reference inner is held to within 1e-4), at 2 and 8
    slabs."""
    cfg, ref_cfg, params, port, x = _case(model, seed=20 + len(model))
    want = _reference("xla", str(sorted(model.items())), params, x, ref_cfg)
    for n in (2, 8):
        got = _sharded(inner, port, x, cfg, n)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f"sharded_{inner}@{n}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("precision", ["bf16", "int8w"])
@pytest.mark.parametrize("inner", sorted(INNERS))
def test_sharded_reduced_policies(inner, precision):
    """The reference's reduced sharded test's case (dilations (1, 2, 4),
    16 x 8 x 8): bf16 halos for the layer-wise inners, the int8 input
    crossing for the megakernel inner at int8w; each within 2e-2 of the
    single-device inner at its policy. Every inner is held to the
    reference's, the megakernel inner to the port's as well."""
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4))
    cfg, ref_cfg, params, port, x = _case(model, seed=30)
    reference = _reference(INNERS[inner], "small", params, x, ref_cfg, precision)
    wants = [reference]
    if inner == "cuda_megakernel":
        wants.append(executors.apply(inner, port, torch.from_numpy(x), cfg, precision=precision).float().numpy())
    for n in SLABS:
        got = _sharded(inner, port, x, cfg, n, precision)
        for want in wants:
            np.testing.assert_allclose(got, want, atol=REDUCED_ATOL, rtol=0, err_msg=f"{inner}@{n}@{precision}")


@pytest.mark.parametrize("n", SLABS)
def test_sharded_megakernel_int8w_within_the_references_bound(n):
    """The reference's bound for the sharded int8w megakernel, 2e-2 of its
    single-device inner (tests/test_precision.py:266), on the case of
    ``test_sharded_reduced_policies`` (fault F2, fixed: the int8w plan
    stages int8 where the reference's does, here nowhere)."""
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4))
    cfg, ref_cfg, params, port, x = _case(model, seed=30)
    reference = _reference("pallas_megakernel", "small", params, x, ref_cfg, "int8w")
    got = _sharded("cuda_megakernel", port, x, cfg, n, "int8w")
    np.testing.assert_allclose(got, reference, atol=REDUCED_ATOL, rtol=0)


def test_int8w_plans_stage_int8_where_the_references_do():
    """The int8w plan of the single-device volume and of every slab +
    halo window (each plans for its own shape, as the reference's windows
    do) stages int8 exactly at the boundaries of the reference's plan at
    that shape: on the reference's sharded case nowhere; for gwm_light's
    9 layers at 16 x 8 x 8 before layers 3-7 and in its taller windows
    4-7 (so there, in both packages, the windows stage otherwise than the
    whole volume), and at 256^3 and in its 4-slab windows before 4 and 5."""
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4))
    cfg, ref_cfg, _, _, _ = _case(model, seed=30)
    gwm = (meshnet.PAPER_MODELS["gwm_light"], ref_meshnet.PAPER_MODELS["gwm_light"])
    cases = [((cfg, ref_cfg), VOL, SLABS, set()), (gwm, VOL, SLABS, {3, 4, 5, 6, 7}),
             (gwm, (256, 256, 256), (4,), {4, 5})]
    for (port_cfg, reference_cfg), vol, slabs, whole in cases:
        for n in (1,) + slabs:
            shape = vol if n == 1 else (vol[0] // n + 2 * sum(port_cfg.dilations),) + vol[1:]
            ref_plan = ref_megakernel.plan_for_config(reference_cfg, shape, precision="int8w")
            pln = megakernel.plan_for_config(port_cfg, shape, precision="int8w")
            assert pln.widths == (2, 1, 1, 1) and pln.int8_at == {seg.start for seg in ref_plan.segments[1:]}
            assert pln.crossings == len(ref_plan.segments) - 1
            if n == 1 or vol[0] == 256 or port_cfg is cfg:
                assert pln.int8_at == whole, (vol, n)
            else:
                assert pln.int8_at == {4, 5, 6, 7}, (vol, n)


def test_sharded_megakernel_int8w_is_the_single_device_forward():
    """At int8w the megakernel inner quantises before the exchange and each
    window plans for its own shape (no int8 crossing here, as in the
    single-device plan); the staging is pointwise, so the slabs give the
    single-device int8w forward to within fp32 rounding."""
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4))
    cfg, _, _, port, x = _case(model, seed=31)
    want = executors.apply("cuda_megakernel", port, torch.from_numpy(x), cfg, precision="int8w").float().numpy()
    got = _sharded("cuda_megakernel", port, x, cfg, 4, "int8w")
    np.testing.assert_allclose(got, want, atol=2.0**-7 * np.abs(want).max(), rtol=0)


def test_batch_shards_two_by_two():
    """Two batch rows of two slabs each: every volume equals its
    single-device forward; the exchange stays within a row."""
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4, 2, 1))
    cfg, ref_cfg, params, port, x = _case(model, seed=40, shape=(4,) + VOL)
    want = _reference("xla", "batch", params, x, ref_cfg)
    for inner in sorted(INNERS):
        got = _sharded(inner, port, x, cfg, 4, num_devices=2, batch_shards=2)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=inner)


def test_sharded_apply_and_infer_on_a_mesh():
    """The standalone demo over a 2 x 2 mesh of CPU devices, and its
    closure, against the single-device forward."""
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4))
    cfg, ref_cfg, params, port, x = _case(model, seed=45, shape=(2,) + VOL)
    want = _reference("xla", "mesh", params, x, ref_cfg)
    mesh = [["cpu", "cpu"], ["cpu", "cpu"]]
    got = spatial_shard.sharded_apply(port, torch.from_numpy(x), cfg, mesh)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    infer = spatial_shard.make_sharded_infer(port, cfg, ["cpu"] * 4)
    np.testing.assert_allclose(infer(torch.from_numpy(x)).numpy(), want, atol=ATOL, rtol=0)
    replicas = spatial_shard.replicate_params(port, ["cpu", "cpu"])
    assert list(replicas) == [torch.device("cpu")]


def test_window_bounds_place_the_volume():
    """Slab i's window holds global rows [i dloc - r, i dloc + dloc + r);
    its bounds are the volume's rows in local coordinates."""
    assert spatial_shard.window_z_bounds(0, 4, 4, 46) == (46, 62)
    assert spatial_shard.window_z_bounds(3, 4, 4, 46) == (34, 50)
    assert spatial_shard.window_z_bounds(1, 64, 4, 46) == (-18, 238)


def test_geometry_errors(monkeypatch):
    cfg, _, _, port, x = _case(dict(channels=5, num_classes=3, dilations=(1,)), seed=50)
    xt = torch.from_numpy(x)
    with pytest.raises(ShardGeometryError, match="not divisible"):
        spatial_shard.sharded_executor_apply("torch", port, xt[:, :15], cfg, devices=["cpu"] * 2)
    with pytest.raises(ShardGeometryError, match="host has 1"):
        spatial_shard.sharded_executor_apply("torch", port, xt, cfg, num_devices=2)
    with pytest.raises(ShardGeometryError, match="2x4 devices; 4 given"):
        spatial_shard.sharded_executor_apply("torch", port, xt, cfg, devices=["cpu"] * 4, num_devices=4,
                                             batch_shards=2)
    with pytest.raises(ShardGeometryError, match="batch 1 not divisible"):
        spatial_shard.sharded_executor_apply("torch", port, xt, cfg, devices=["cpu"] * 4, num_devices=2,
                                             batch_shards=2)
    with pytest.raises(ShardGeometryError):
        spatial_shard.mesh_for(2, "cpu")
    with pytest.raises(ShardGeometryError):
        spatial_shard.mesh_for_batched(2, 2, "cpu")
    with pytest.raises(KeyError, match="unknown sharded inner"):
        spatial_shard.sharded_executor_apply("streaming", port, xt, cfg, devices=["cpu"] * 2)
    _cpu_devices(monkeypatch, 8)
    assert spatial_shard.mesh_for(None, "cpu") == [torch.device("cpu")] * 8
    assert spatial_shard.auto_batch_shards(4, 2, "cpu") == 4
    assert spatial_shard.auto_batch_shards(3, 4, "cpu") == 1
    assert spatial_shard.auto_batch_shards(6, 4, "cpu") == 2


# ------------------------------------------------------------- registry ---


def test_sharded_names_parse_and_register():
    assert executors.sharded_name("cuda_fused") == "sharded_cuda_fused"
    assert executors.sharded_name("cuda_fused", 4) == "sharded_cuda_fused@4"
    assert executors.parse_sharded("sharded_torch@8") == ("torch", 8)
    assert executors.parse_sharded("sharded_cuda_megakernel") == ("cuda_megakernel", None)
    assert executors.parse_sharded("cuda_fused") is None
    assert executors.inner_of("sharded_torch@2") == "torch" and executors.inner_of("torch") == "torch"
    assert executors.shardable("cuda_megakernel") and not executors.shardable("streaming")
    for bad, match in [("sharded_streaming@2", "sharded inner must be one of"),
                       ("sharded_torch@0", "positive integer"), ("sharded_torch@x", "positive integer")]:
        with pytest.raises(KeyError, match=match):
            executors.resolve(bad)
    with pytest.raises(KeyError, match="cannot be sharded"):
        executors.ensure_sharded("streaming", 2)
    name = executors.resolve("sharded_cuda_fused@4")
    assert name == "sharded_cuda_fused@4" and executors.get(name).name == name
    assert executors.ensure_sharded("sharded_cuda_fused@2", 4) == name
    assert name not in executors.names()  # the open-ended family is listed apart
    assert executors.reference_name(name) == "sharded_pallas_fused@4"
    assert executors.reference_name("sharded_torch") == "sharded_xla"
    assert executors.reference_name("cuda_megakernel") == "pallas_megakernel"
    assert name not in executors.REFERENCE_NAMES  # a plain dict of the base names
    with pytest.raises(KeyError):
        executors.reference_name("nothing")


def test_registry_apply_runs_the_sharded_spec(monkeypatch):
    _cpu_devices(monkeypatch, 4)
    cfg, ref_cfg, params, port, x = _case(dict(channels=5, num_classes=3, dilations=(1, 2, 4)), seed=55)
    want = _reference("xla", "small55", params, x, ref_cfg)
    for name in ("sharded_torch@4", "sharded_cuda_megakernel"):
        got = executors.apply(name, port, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("inner", sorted(INNERS))
def test_collective_bytes_are_the_references(inner, precision):
    for model in ("gwm_light", "subvolume_gwm_failsafe", "atlas_104"):
        cfg, ref_cfg = meshnet.PAPER_MODELS[model], ref_meshnet.PAPER_MODELS[model]
        for vol, n in [((256, 256, 256), 4), ((64, 16, 16), 8), ((32, 8, 8), 1)]:
            got = traffic.meshnet_collective_bytes(cfg, vol, n, batch=2, precision=precision)
            assert got == ref_traffic.meshnet_collective_bytes(ref_cfg, vol, n, batch=2, precision=precision)
            spec = executors.get(executors.ensure_sharded(inner, n))
            assert spec.collective_bytes(cfg, vol, batch=2, precision=precision) == got
    assert traffic.meshnet_collective_bytes(cfg, (64, 16, 16), 4, precision="bf16") * 2 == \
        traffic.meshnet_collective_bytes(cfg, (64, 16, 16), 4)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8w"])
@pytest.mark.parametrize("inner", sorted(INNERS))
def test_sharded_bytes_follow_the_references_convention(inner, precision):
    """n times the inner's model at a slab (the megakernel's at the slab
    and the radius a side). The ``torch`` inner's model is the reference's
    ``xla`` model, so its numbers are the reference's; the kernels' inner
    models are the port's own (telemetry/traffic.py), so theirs follow the
    same convention over them."""
    cfg, ref_cfg = meshnet.PAPER_MODELS["gwm_light"], ref_meshnet.PAPER_MODELS["gwm_light"]
    vol, n = (256, 256, 256), 4
    got = traffic.meshnet_sharded_bytes(inner, cfg, vol, n, precision=precision)
    window = (64 + 2 * 46, 256, 256) if inner == "cuda_megakernel" else (64, 256, 256)
    assert got == n * traffic.EXECUTOR_MODELS[inner](cfg, window, precision=precision)
    assert executors.modeled_hbm_bytes(executors.sharded_name(inner, n), cfg, vol, precision=precision) == got
    if inner == "torch":
        assert got == ref_traffic.meshnet_sharded_bytes("xla", ref_cfg, vol, n, precision=precision)
    with pytest.raises(ShardGeometryError):
        traffic.meshnet_sharded_bytes(inner, cfg, (30, 8, 8), 4, precision=precision)


# ------------------------------------------------------ pipeline, engine ---


def _pipeline_case(seed):
    model = dict(channels=5, num_classes=3, dilations=(1, 2, 4))
    cfg, ref_cfg = _cfgs(**model)
    params = _np_params(cfg, seed)
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in VOL], indexing="ij")
    r = np.sqrt((zz / 0.6) ** 2 + (yy / 0.8) ** 2 + (xx / 0.7) ** 2)
    vol = (np.where(r < 1.0, 120.0 - 60.0 * r, 5.0) + 8.0 * rng.standard_normal(VOL)).astype(np.float32)
    return cfg, ref_cfg, params, bridge.params_from_numpy(params, "cpu"), vol


def test_pipeline_shard_devices(monkeypatch):
    """shard_devices re-wraps the resolved executor; the record carries the
    sharded name, the reference's collective-byte model and the
    reference's single-device segmentation; 1 unwraps; streaming stays
    single-device; lacking devices and a depth that does not divide fail
    typed."""
    _cpu_devices(monkeypatch, 4)
    cfg, ref_cfg, params, port, vol = _pipeline_case(60)
    base = pipeline.PipelineConfig(model=cfg, volume_shape=VOL, min_component_size=4, executor="torch")
    ref_pc = ref_pipeline.PipelineConfig(model=ref_cfg, volume_shape=VOL, min_component_size=4, executor="xla")
    want = np.asarray(ref_pipeline.run(ref_pc, params, jnp.asarray(vol)).segmentation)
    for executor, shard, name in [("torch", 2, "sharded_torch@2"), ("cuda_megakernel", 4, "sharded_cuda_megakernel@4"),
                                  ("sharded_cuda_fused@4", 2, "sharded_cuda_fused@4")]:
        pc = dataclasses.replace(base, executor=executor, shard_devices=shard)
        res = pipeline.run(pc, port, vol, device="cpu")
        assert res.record.status == "ok", res.record.fail_type
        assert res.record.executor == name
        n = int(name.rsplit("@", 1)[1])
        assert res.record.collective_bytes_modeled == ref_traffic.meshnet_collective_bytes(ref_cfg, VOL, n) > 0
        assert res.record.hbm_bytes_modeled > 0
        np.testing.assert_array_equal(res.segmentation.numpy(), want)
    res = pipeline.run(dataclasses.replace(base, executor="sharded_torch@2", shard_devices=1), port, vol, device="cpu")
    assert (res.record.executor, res.record.collective_bytes_modeled) == ("torch", 0)
    res = pipeline.run(dataclasses.replace(base, executor="streaming", shard_devices=2), port, vol, device="cpu")
    assert res.record.status == "ok" and res.record.executor == "streaming"
    res = pipeline.run(dataclasses.replace(base, shard_devices=8), port, vol, device="cpu")
    assert (res.record.status, res.record.fail_type, res.record.executor) == ("fail", "shard_geometry",
                                                                             "sharded_torch@8")
    odd = dataclasses.replace(base, volume_shape=(15, 8, 8), shard_devices=2)
    res = pipeline.run(odd, port, vol, device="cpu")
    assert (res.record.status, res.record.fail_type) == ("fail", "shard_geometry")


def test_pipeline_subvolume_prices_each_cube(monkeypatch):
    _cpu_devices(monkeypatch, 2)
    cfg, ref_cfg, _, port, vol = _pipeline_case(62)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=VOL, mode="subvolume", cube=8, overlap=4,
                                 min_component_size=4, executor="torch", shard_devices=2)
    res = pipeline.run(pc, port, vol, device="cpu")
    assert res.record.status == "ok" and res.record.executor == "sharded_torch@2"
    cubes = 2  # 16 x 8 x 8 in cubes of 8: 2 x 1 x 1, each padded by 4 a side to 16^3
    assert res.record.collective_bytes_modeled == cubes * ref_traffic.meshnet_collective_bytes(ref_cfg, (16, 16, 16), 2)
    single = pipeline.run(dataclasses.replace(pc, shard_devices=None), port, vol, device="cpu")
    np.testing.assert_array_equal(res.segmentation.numpy(), single.segmentation.numpy())


def test_engine_device_counts(monkeypatch):
    """The engine's slab count and a request's override: 2 by default, 1
    for one request, 4 for another; an engine asking for more devices than
    the host has refuses at construction."""
    _cpu_devices(monkeypatch, 4)
    cfg, _, _, port, vol = _pipeline_case(64)
    pc = pipeline.PipelineConfig(model=cfg, volume_shape=VOL, min_component_size=4, executor="cuda_fused")
    engine = SegmentationEngine(port, pc, devices=2, device="cpu")
    runs = [engine.submit(vol, mode="full"), engine.submit(vol, mode="full", devices=1),
            engine.submit(vol, mode="full", devices=4)]
    assert [r.record.executor for r in runs] == ["sharded_cuda_fused@2", "cuda_fused", "sharded_cuda_fused@4"]
    assert all(r.record.status == "ok" for r in runs)
    for r in runs[1:]:
        np.testing.assert_array_equal(r.segmentation.numpy(), runs[0].segmentation.numpy())
    assert [r.executor for r in engine.log.records] == [r.record.executor for r in runs]
    assert SegmentationEngine(port, dataclasses.replace(pc, shard_devices=4), device="cpu").devices == 4
    with pytest.raises(ShardGeometryError):
        SegmentationEngine(port, pc, devices=8, device="cpu")
