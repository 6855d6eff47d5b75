#!/usr/bin/env python3
"""Drive the PyTorch port's segmentation main paths on one CUDA card.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # tiny shapes, plain paths, CPU

The port has two kernel-backed forwards: ``cuda_fused`` (K1, the fused
dilated conv, one launch per layer) and ``cuda_megakernel`` (K2, the
depth-first segment kernel, one launch per segment of a plan). Phases,
each printed on lines of its own:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel source of the port, all at once,
            timed, with ptxas' register and shared-memory report
3. parity   K1 against its plain PyTorch version on the card, relative
            error <= 5e-5 of the output's magnitude; then K2 segment by
            segment against its plain version (same staging arrays in,
            borders filled with NaN), <= 5e-5, over widths 5/10/18/21,
            heads of 2/3/50/104 classes, batch 2 at odd shapes, and plans
            forced to several segments by small shared-memory budgets
4. forward  gwm_light and the crop model brain_mask_fast at 256^3, each
            against its plain forward: the K1 forward within 2e-4 and the
            K2 forward (each model on its own 256^3 plan) within 1e-4
            relative, argmax agreeing on >= 99.99 % of voxels
5. serve    SegmentationEngine.submit on 3 synthetic volumes (one raw
            shape non-cubic), brain_mask_fast as the crop model:
            5a  executor cuda_fused, K1 launched exactly 18 times a request
                (9 mask layers + 9 main layers);
            5b  executor cuda_megakernel, K2 launched exactly (mask plan's
                segments + main plan's segments) times a request and K1
                never; each segmentation agrees with executor torch on
                >= 99.99 % of voxels.
            Each of 5a and 5b is a main path: every launch count is set to
            0 just before it and read just after. One more request of each
            runs under torch.profiler: device time by kernel and the share
            of the request the card was busy.
6. times    CUDA-event medians of 20 runs: K1 at the main path's layer
            shapes (kernel, plain, F.conv3d with TF32 off, bound); K2 per
            segment of the 256^3 plan (kernel, plain, bound), and the d = 4
            one-layer segment at tiles 16^3, 32^3, 64^3; the whole forwards.
            Each bound counts the function's own work, as K1's does: the
            in-volume taps, each input read once and each output written
            once. K2's plan_bound_ms prices its schedule instead: the halo
            recompute and the haloed window reads of the byte model
6b. kernels one JSON line describing every ported kernel
7. ok       the last line, {"ok": true, "device": {...}}

Any failed check raises, so the script exits non-zero and prints no ok
line. Without a CUDA device (and without --cpu-rehearsal) it exits 1.
--cpu-rehearsal runs phases 1, 4 and 5 at a tiny size on the CPU with the
plain versions, to find wrong paths and shapes without a card; it never
prints the ok line.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import synchronize  # noqa: E402
from repro_torch.core import conform, meshnet  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.data import mri  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import dilated_conv3d as k1  # noqa: E402
from repro_torch.kernels import megakernel as k2  # noqa: E402
from repro_torch.serving.engine import SegmentationEngine  # noqa: E402

KERNEL_REL_TOL = 5e-5
FORWARD_REL_TOL = 2e-4  # the fused forward (tests/test_executors.py)
MEGA_FORWARD_REL_TOL = 1e-4  # the megakernel forward (tests/test_megakernel.py)
ARGMAX_AGREE = 0.9999
SEED = 0

# Published peaks per card: fp32 outside the tensor cores, device memory.
# (NVIDIA H100 data sheet; dense rates at the card's full power limit.)
PEAKS = {
    "H100 SXM": (67e12, 3.35e12),
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def peaks_for(name: str) -> tuple[str, float, float]:
    key = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name else "H100 SXM"
    return (key, *PEAKS[key])


def with_bn_stats(params, gen: torch.Generator):
    """Non-trivial BatchNorm running statistics, so the folded epilogue is real."""
    for layer in params["layers"]:
        c = layer["b"].shape[0]
        dev = layer["b"].device
        layer["b"] = (0.1 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_scale"] = (1.0 + 0.2 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_bias"] = (0.1 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_mean"] = (0.3 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_var"] = (0.5 + torch.rand(c, generator=gen)).to(dev)
    return params


def rel_err(got: torch.Tensor, expect: torch.Tensor) -> tuple[float, float]:
    abs_err = float((got - expect).abs().max())
    return abs_err, abs_err / max(float(expect.abs().max()), 1e-30)


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn``, after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def conv_inputs(gen, shape, cin, cout, device):
    x = torch.randn(shape + (cin,), generator=gen)
    w = torch.randn((3, 3, 3, cin, cout), generator=gen) * (2.0 / (27 * cin)) ** 0.5
    b = 0.1 * torch.randn(cout, generator=gen)
    s = 0.5 + torch.rand(cout, generator=gen)
    o = 0.1 * torch.randn(cout, generator=gen)
    return [t.to(device) for t in (x, w, b, s, o)]


def k1_work(shape, cin, cout, dilation) -> tuple[int, int]:
    """(operations, bytes) K1 must do and move: one multiply-add per
    in-volume tap and channel pair plus the 4-op epilogue; each input read
    once, each output written once."""
    b, *spatial = shape
    taps = b
    for n in spatial:
        taps *= 3 * n - 2 * min(dilation, n)  # in-volume (voxel, tap) pairs on this axis
    voxels = b * spatial[0] * spatial[1] * spatial[2]
    ops_ = 2 * taps * cin * cout + 4 * voxels * cout
    bytes_ = 4 * (voxels * cin + 27 * cin * cout + 3 * cout + voxels * cout)
    return ops_, bytes_


def k2_work(pln, i: int) -> tuple[int, int]:
    """(operations, bytes) segment i of ``pln`` must do and move, counted
    as K1's are: each layer's in-volume taps and epilogue over the true
    volume, the fused head's products and bias; the segment's input read
    once, its parameters once, its output written once. The plan's halo
    recompute and haloed window reads are not part of the function: they
    price the schedule (``plan_bound_ms``)."""
    seg = pln.segments[i]
    shape, voxels = (1,) + tuple(pln.vol), math.prod(pln.vol)
    ops_, cin = 0, seg.cin
    for d in seg.dilations:
        ops_ += k1_work(shape, cin, seg.channels, d)[0]
        cin = seg.channels
    if seg.fuse_head:
        ops_ += 2 * voxels * seg.channels * seg.num_classes + voxels * seg.num_classes
    n_params = k2._smem_layout(seg)[0]  # weights, bias, scale, offset; the head's
    return ops_, 4 * (voxels * seg.cin + n_params + voxels * seg.cout)


def phase_device(rehearsal: bool) -> str:
    print("== phase 1: device")
    if rehearsal:
        print("card: none (cpu rehearsal)")
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(f"card: {smi.stdout.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    name = torch.cuda.get_device_name(0)
    print(f"device 0: {name}; devices: {torch.cuda.device_count()}")
    key, flops, bw = peaks_for(name)
    print(f"peaks used for bounds ({key}): fp32 {flops / 1e12:.0f} TFLOP/s, memory {bw / 1e12:.2f} TB/s")
    return name


def phase_build() -> None:
    print("== phase 2: build")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"built {sorted(seconds)} in {time.perf_counter() - t0:.2f} s wall; per source: {seconds}")
    for name in seconds:
        report = [line for line in _build.build_log(name).splitlines() if "ptxas" in line or "spill" in line]
        print(f"-- {name}.cu ptxas:\n" + "\n".join(report))


def phase_parity(dev) -> tuple[float, float]:
    print("== phase 3: K1 parity against the plain version (card)")
    gen = torch.Generator().manual_seed(SEED + 3)
    cases = [((1, 64, 64, 64), 5, 5, d, affine) for d in (1, 2, 4, 8, 16) for affine in (False, True)]
    cases += [
        ((1, 64, 64, 64), 1, 5, 1, True),
        ((1, 64, 64, 64), 21, 21, 4, True),
        ((1, 64, 64, 64), 21, 21, 16, False),
        ((1, 48, 48, 48), 10, 10, 2, True),
        ((1, 48, 48, 48), 18, 18, 8, True),
        ((2, 37, 45, 29), 5, 5, 16, True),
        ((2, 37, 45, 29), 1, 5, 2, False),
    ]
    worst_abs = worst_rel = 0.0
    for shape, cin, cout, d, affine in cases:
        x, w, b, s, o = conv_inputs(gen, shape, cin, cout, dev)
        kw = dict(dilation=d, scale=s, offset=o, fuse_affine=affine)
        got = k1.dilated_conv3d(x, w, b, **kw)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref.dilated_conv3d(x, w, b, **kw))
        print(f"K1 {shape} {cin}->{cout} d={d} affine={affine}: max_abs_err {abs_err:.3e} rel {rel:.3e}")
        check(rel <= KERNEL_REL_TOL, f"K1 rel err {rel} > {KERNEL_REL_TOL} at {shape} {cin}->{cout} d={d}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
    return worst_abs, worst_rel


def written(pln, i: int) -> tuple:
    """Index of the region of segment i's output array that K2 writes."""
    o = pln.out_halo(i)
    return (slice(None),) + tuple(slice(o, o + p) for p in pln.padded(pln.segments[i])) + (slice(None),)


def with_nan_border(t: torch.Tensor, region: tuple) -> torch.Tensor:
    """A copy of staging array ``t`` whose border (all but ``region``) is NaN."""
    out = torch.full_like(t, float("nan"))
    out[region] = t[region]
    return out


def k2_stagings(pln, params, cfg, x: torch.Tensor):
    """Yield (i, input staging, layers, head) for every segment of ``pln``,
    each input the kernel's output of the segment before, its border NaN."""
    first = pln.segments[0]
    h = first.halo
    act = torch.full((x.shape[0],) + tuple(p + 2 * h for p in pln.padded(first)) + (x.shape[-1],),
                     float("nan"), device=x.device)
    act[:, h : h + pln.vol[0], h : h + pln.vol[1], h : h + pln.vol[2], :] = x
    for i, seg in enumerate(pln.segments):
        layers, head = ops.megakernel_operands(params, cfg, seg)
        yield i, act, layers, head
        if i + 1 < len(pln.segments):
            act = with_nan_border(k2.run_segment(act, pln, i, layers, head), written(pln, i))


def phase_parity_k2(dev) -> tuple[float, float]:
    print("== phase 3b: K2 parity against the plain version (card), segment by segment, NaN borders")
    gen = torch.Generator().manual_seed(SEED + 33)
    M = meshnet.MeshNetConfig
    cases = [  # (config, (B, D, H, W), shared-memory budget)
        (meshnet.PAPER_MODELS["gwm_light"], (1, 64, 64, 64), k2.SMEM_BUDGET),
        (meshnet.PAPER_MODELS["brain_mask_fast"], (2, 37, 45, 29), k2.SMEM_BUDGET),
        (M(channels=5, num_classes=2, dilations=(1, 1, 2, 1)), (2, 30, 26, 29), k2.SMEM_BUDGET),
        (M(channels=10, num_classes=2, dilations=(1, 2, 4, 8, 16, 8, 4, 2, 1)), (1, 48, 48, 48), 60_000),
        (M(channels=10, num_classes=50, dilations=(1, 2, 1, 1)), (2, 33, 20, 27), k2.SMEM_BUDGET),
        (M(channels=18, num_classes=104, dilations=(1, 2, 4, 2, 1)), (1, 40, 40, 40), k2.SMEM_BUDGET),
        (M(channels=21, num_classes=3, dilations=(1, 2, 4, 2, 1)), (2, 37, 45, 29), 120_000),
    ]
    worst_abs = worst_rel = 0.0
    for cfg, shape, budget in cases:
        params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
        x = torch.rand(shape + (cfg.in_channels,), generator=gen).to(dev)
        pln = k2.plan_for_config(cfg, shape[1:], smem_budget=budget, batch=shape[0])
        for i, act, layers, head in k2_stagings(pln, params, cfg, x):
            seg = pln.segments[i]
            got = k2.run_segment(act, pln, i, layers, head)[written(pln, i)]
            torch.cuda.synchronize()
            expect = ref.megakernel_segment(act, pln, i, layers, head)[written(pln, i)]
            check(bool(torch.isfinite(got).all()), f"K2 output finite at {shape} segment {i}")
            abs_err, rel = rel_err(got, expect)
            print(f"K2 C={cfg.channels} classes={cfg.num_classes} {shape} budget {budget} segment {i}/{len(pln.segments)} "
                  f"dilations {seg.dilations} tile {seg.tile} head {seg.fuse_head}: max_abs_err {abs_err:.3e} rel {rel:.3e}")
            check(rel <= KERNEL_REL_TOL, f"K2 rel err {rel} > {KERNEL_REL_TOL} at {shape} segment {i}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)
    return worst_abs, worst_rel


def phase_forward(dev, size: int) -> None:
    print(f"== phase 4: the served models' forwards at {size}^3, kernel paths vs plain path")
    gen = torch.Generator().manual_seed(SEED + 4)
    cfg, mcfg = meshnet.PAPER_MODELS["gwm_light"], meshnet.PAPER_MODELS["brain_mask_fast"]
    models = [("gwm_light", cfg, with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen))]
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    x = conform.conform(vol, (size,) * 3)[None]
    # the crop stage's mask forward, at the size and plan it is served with
    models.append(("brain_mask_fast", mcfg, with_bn_stats(meshnet.init(mcfg, generator=gen, device=dev), gen)))
    for model, cfg, params in models:
        expect = meshnet.apply(params, x, cfg)
        pln = k2.plan_for_config(cfg, (size,) * 3)
        print(f"{model} megakernel plan: {[(s.dilations, s.tile) for s in pln.segments]}; "
              f"modeled bytes {pln.hbm_bytes()}; multiply-adds {pln.operations()}")
        for name, fn, tol in (("cuda_fused", ops.meshnet_apply, FORWARD_REL_TOL),
                              ("cuda_megakernel", ops.meshnet_apply_megakernel, MEGA_FORWARD_REL_TOL)):
            got = fn(params, x, cfg)
            what = f"{model} {name}"
            check(bool(torch.isfinite(got).all()), f"{what} forward logits are finite")
            check(tuple(got.shape) == (1, size, size, size, cfg.num_classes), f"{what} logits shape {tuple(got.shape)}")
            abs_err, rel = rel_err(got, expect)
            disagree = int((got.argmax(-1) != expect.argmax(-1)).sum())
            agree = 1.0 - disagree / got[..., 0].numel()
            print(f"{what}: logits max_abs_err {abs_err:.3e} rel {rel:.3e}; argmax disagrees on {disagree} voxels ({agree:.6%} agree)")
            check(rel <= tol, f"{what} forward rel err {rel} > {tol}")
            check(agree >= ARGMAX_AGREE, f"{what} argmax agreement {agree} < {ARGMAX_AGREE}")
        del expect, got


def serve_path(engine, vols, plain, executor, expect_exec, per_request) -> dict:
    """Serve ``vols`` through ``engine`` under ``executor`` (None: the
    engine's "auto"): a main path. Every launch count is 0 just before it
    and read just after. ``per_request(record)`` gives the (K1, K2)
    launches a request must make."""
    dev = engine.device
    synchronize(dev)
    k1.launches = k2.launches = 0  # main path starts
    for i, vol in enumerate(vols):
        before = (k1.launches, k2.launches)
        t0 = time.perf_counter()
        res = engine.submit(vol, executor=executor)
        wall = time.perf_counter() - t0
        rec, st = res.record, res.record.times
        launched = (k1.launches - before[0], k2.launches - before[1])
        print(
            f"{expect_exec} request {i} raw {tuple(vol.shape)}: status {rec.status} mode {rec.mode} executor {rec.executor} "
            f"crop {rec.crop_size} launches K1 {launched[0]} K2 {launched[1]}; modeled bytes {rec.hbm_bytes_modeled}; "
            f"stage s: preprocessing {st.preprocessing:.4f} cropping {st.cropping:.4f} inference {st.inference:.4f} "
            f"postprocessing {st.postprocessing:.4f} total {st.total():.4f}; submit wall {wall:.4f}"
        )
        check(rec.status == "ok", f"request {i} status {rec.status} ({rec.fail_type})")
        check(rec.executor == expect_exec, f"request {i} executor {rec.executor}")
        seg = res.segmentation
        check(tuple(seg.shape) == tuple(plain[i].segmentation.shape) and seg.device.type == dev.type,
              f"request {i} segmentation {tuple(seg.shape)} on {seg.device}")
        expected = per_request(rec) if dev.type == "cuda" else (0, 0)
        check(launched == expected, f"request {i} launched (K1, K2) {launched}, expected {expected}")
        check(plain[i].record.crop_size == rec.crop_size, "crop size agrees with the plain path")
        differ = int((plain[i].segmentation != seg).sum())
        agree = 1.0 - differ / seg.numel()
        print(f"{expect_exec} request {i} vs executor torch: {differ} voxels differ ({agree:.6%} agree)")
        check(agree >= ARGMAX_AGREE, f"segmentation agreement {agree} < {ARGMAX_AGREE}")
        last = res
    counts = {"K1": k1.launches, "K2": k2.launches}  # main path ends
    if dev.type == "cuda":
        profile_request(engine, vols[0], executor, unprofiled_s=last.record.times.total())
    return counts


def phase_serve(dev, size: int) -> dict:
    print(f"== phase 5: serve 3 requests at {size}^3 through SegmentationEngine.submit, once per kernel path")
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    mcfg = meshnet.PAPER_MODELS["brain_mask_fast"]
    gen = torch.Generator().manual_seed(SEED + 5)
    params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
    mparams = with_bn_stats(meshnet.init(mcfg, generator=gen, device=dev), gen)
    shape = (size,) * 3
    raw_shapes = [shape, shape, (size - size // 16, size, size - size // 8)]
    vols = [mri.generate(gen, mri.SyntheticMRIConfig(shape=s), device=dev)[0] for s in raw_shapes]
    engine = SegmentationEngine(
        params,
        PipelineConfig(name="gwm_light", model=cfg, volume_shape=shape, use_cropping=True),
        mask_model=(mparams, mcfg),
        device=dev,
    )
    plain = [engine.submit(v, executor="torch") for v in vols]
    for i, res in enumerate(plain):
        check(res.record.status == "ok" and res.record.executor == "torch", f"plain-path request {i}")
        labels = torch.bincount(res.segmentation.reshape(-1).long(), minlength=cfg.num_classes).tolist()
        print(f"torch request {i}: crop {res.record.crop_size}; label counts {labels}")

    print("-- 5a: executor auto (cuda_fused on the card): main path of K1")
    fused_exec = "cuda_fused" if dev.type == "cuda" else "torch"
    counts = {"cuda_fused": serve_path(engine, vols, plain, None, fused_exec, lambda rec: (2 * len(cfg.dilations), 0))}
    check(dev.type != "cuda" or counts["cuda_fused"]["K1"] > 0, "K1 was not launched on its main path")

    print("-- 5b: executor cuda_megakernel: main path of K2")
    mask_segments = len(k2.plan_for_config(mcfg, shape).segments)

    def k2_per_request(rec):
        return (0, mask_segments + len(k2.plan_for_config(cfg, rec.crop_size).segments))

    counts["cuda_megakernel"] = serve_path(engine, vols, plain, "cuda_megakernel", "cuda_megakernel", k2_per_request)
    check(dev.type != "cuda" or counts["cuda_megakernel"]["K2"] > 0, "K2 was not launched on its main path")
    return counts


def profile_request(engine, vol, executor, unprofiled_s: float) -> None:
    """Device time of one more request by kernel, from a torch.profiler
    trace, and the share of the request the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.submit(vol, executor=executor)
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # time of the kernels it launched
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in cuda) / 1e6
    if busy_s == 0:
        print("profile: the profiler saw no device time; busy share not measured")
        return
    print(
        f"profile ({executor or 'auto'}): device busy {busy_s:.4f} s of a profiled request of {wall:.4f} s "
        f"({busy_s / wall:.1%}); {busy_s / unprofiled_s:.1%} of the unprofiled request's {unprofiled_s:.4f} s"
    )
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


def bound(ops_: float, bytes_: float, peak_flops: float, peak_bw: float) -> tuple[float, str]:
    t_ops, t_bytes = ops_ / peak_flops * 1e3, bytes_ / peak_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_times(dev, card: str, size: int) -> tuple[list[dict], list[dict]]:
    print(f"== phase 6: times at the main path's shapes ({size}^3, card: {card})")
    torch.backends.cudnn.benchmark = False
    _, peak_flops, peak_bw = peaks_for(card)
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    per_forward = {}
    cin = cfg.in_channels
    for d in cfg.dilations:
        per_forward[(d, cin)] = per_forward.get((d, cin), 0) + 1
        cin = cfg.channels
    gen = torch.Generator().manual_seed(SEED + 6)
    rows = []
    for (d, cin), count in sorted(per_forward.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        cout = cfg.channels
        shape = (1, size, size, size)
        x, w, b, s, o = conv_inputs(gen, shape, cin, cout, dev)
        kw = dict(dilation=d, scale=s, offset=o, fuse_affine=True)
        x_ncdhw = x.permute(0, 4, 1, 2, 3)  # a view: the data stays channels-last
        w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
        lib_out = F.conv3d(x_ncdhw, w_oidhw, b, padding=d, dilation=d).permute(0, 2, 3, 4, 1)
        _, lib_rel = rel_err(lib_out, ref.dilated_conv3d(x, w, b, dilation=d))
        kernel_ms = time_ms(lambda: k1.dilated_conv3d(x, w, b, **kw))
        plain_ms = time_ms(lambda: ref.dilated_conv3d(x, w, b, **kw))
        library_ms = time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, b, padding=d, dilation=d))
        ops_, bytes_ = k1_work(shape, cin, cout, d)
        bound_ms, bound_by = bound(ops_, bytes_, peak_flops, peak_bw)
        row = dict(
            dilation=d, cin=cin, cout=cout, launches_per_forward=count,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, ops=ops_, bytes=bytes_, library_rel_err=lib_rel,
        )
        print("times " + json.dumps(row))
        rows.append(row)
        del x, lib_out

    # K2: every segment of the 256^3 plan on the staging array it reads.
    params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    x = conform.conform(vol, (size,) * 3)[None, ..., None]
    pln = k2.plan_for_config(cfg, (size,) * 3)
    seg_rows = []
    for i, act, layers, head in k2_stagings(pln, params, cfg, x):
        seg = pln.segments[i]
        kernel_ms = time_ms(lambda: k2.run_segment(act, pln, i, layers, head))
        plain_ms = time_ms(lambda: ref.megakernel_segment(act, pln, i, layers, head))
        ops_, bytes_ = k2_work(pln, i)
        bound_ms, bound_by = bound(ops_, bytes_, peak_flops, peak_bw)
        macs, modeled = pln.segment_operations(i), pln.segment_hbm_bytes(i)
        plan_bound_ms, plan_bound_by = bound(2 * macs, modeled, peak_flops, peak_bw)
        row = dict(
            segment=i, dilations=list(seg.dilations), tile=list(seg.tile), fuse_head=seg.fuse_head,
            smem_bytes=int(k2._segment_smem_bytes(seg)), blocks=math.prod(p // t for p, t in zip(pln.padded(seg), seg.tile)),
            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, ops=ops_, bytes=bytes_,
            plan_bound_ms=plan_bound_ms, plan_bound_by=plan_bound_by, multiply_adds=macs, modeled_bytes=modeled,
        )
        print("times " + json.dumps(row))
        seg_rows.append(row)

    # The plan's one-layer segments take tiles of 64^3, so 64 blocks. The
    # d = 4 layer alone at smaller tiles shows what the block count costs.
    staging = torch.rand((1,) + (size + 8,) * 3 + (cfg.channels,), generator=gen).to(dev)
    for t in (16, 32, 64):
        seg = k2.Segment(2, (4,), cfg.channels, cfg.channels, (t, t, t))
        one = k2.MegakernelPlan((seg,), (size,) * 3)
        operands = ops.megakernel_operands(params, cfg, seg)
        ms = time_ms(lambda: k2.run_segment(staging, one, 0, *operands))
        print("times tile sweep " + json.dumps(dict(dilation=4, tile=t, blocks=(-(-size // t)) ** 3, kernel_ms=ms)))

    xs = x[..., 0]
    for name, fn in (("torch", meshnet.apply), ("cuda_fused", ops.meshnet_apply),
                     ("cuda_megakernel", ops.meshnet_apply_megakernel)):
        print(f"times forward {name}: {time_ms(lambda: fn(params, xs, cfg)):.4f} ms (one gwm_light forward at {size}^3)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"after timing: clocks.sm, power.draw, power.limit, temperature: {smi.stdout.strip()}")
    return rows, seg_rows


def kernels_line(rows, seg_rows, launches: dict, k1_err, k2_err) -> dict:
    """Per-forward numbers of each kernel: one gwm_light forward at 256^3,
    9 launches of K1 or one launch of K2 per segment of the plan."""

    def totals(rs, per=lambda r: 1):
        t = {k: sum(r[k] * per(r) for r in rs) for k in ("kernel_ms", "plain_ms")}
        t_ops = sum(r["bound_ms"] * per(r) for r in rs if r["bound_by"] == "operations")
        t_bytes = sum(r["bound_ms"] * per(r) for r in rs if r["bound_by"] == "bytes")
        return t, t_ops + t_bytes, "operations" if t_ops >= t_bytes else "bytes"

    t1, b1, by1 = totals(rows, lambda r: r["launches_per_forward"])
    t2, b2, by2 = totals(seg_rows)
    return {
        "kernels": [
            {
                "name": "dilated_conv3d",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dilated_conv3d.cu",
                "replaces": "src/repro/kernels/dilated_conv3d.py:62",
                "tpu_kernel": "src/repro/kernels/dilated_conv3d.py::_halo_kernel",
                "launches": launches["cuda_fused"]["K1"],
                "max_abs_err": k1_err[0],
                "max_rel_err": k1_err[1],
                "ms": t1["kernel_ms"],
                "plain_ms": t1["plain_ms"],
                "bound_ms": b1,
                "bound_by": by1,
                "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in rows),
                "per": "one gwm_light forward at 256^3 (9 launches); sums of per-layer medians",
            },
            {
                "name": "megakernel_segment",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/megakernel.cu",
                "replaces": "src/repro/kernels/megakernel.py:482",
                "tpu_kernel": "src/repro/kernels/megakernel.py::_segment_kernel",
                "launches": launches["cuda_megakernel"]["K2"],
                "max_abs_err": k2_err[0],
                "max_rel_err": k2_err[1],
                "ms": t2["kernel_ms"],
                "plain_ms": t2["plain_ms"],
                "bound_ms": b2,
                "bound_by": by2,
                "library_ms": None,
                "plan_bound_ms": sum(r["plan_bound_ms"] for r in seg_rows),
                "per": f"one gwm_light forward at 256^3 ({len(seg_rows)} launches, one a segment); sums of per-segment medians",
            },
        ]
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true", help="tiny shapes, plain paths, CPU; never prints ok")
    args = parser.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu" if rehearsal else "cuda")
    size = 24 if rehearsal else 256
    t_start = time.perf_counter()

    card = phase_device(rehearsal)
    if not rehearsal:
        phase_build()
        k1_err = phase_parity(dev)
        k2_err = phase_parity_k2(dev)
    phase_forward(dev, size)
    launches = phase_serve(dev, size)
    if rehearsal:
        print(f"cpu rehearsal done in {time.perf_counter() - t_start:.1f} s (no ok line)")
        return 0
    rows, seg_rows = phase_times(dev, card, size)
    print(json.dumps(kernels_line(rows, seg_rows, launches, k1_err, k2_err)))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
