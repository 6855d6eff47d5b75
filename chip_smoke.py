#!/usr/bin/env python3
"""Drive the PyTorch port's segmentation and training main paths on one
CUDA card.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # tiny shapes, plain paths, CPU

The port has two kernel-backed forwards: ``cuda_fused`` (K1, the fused
dilated conv, one launch per layer) and ``cuda_megakernel`` (K2, the
depth-first segment kernel, one launch per segment of a plan); and a
training path whose hard Dice metric and held-out scores go through K3
(the per-class Dice count kernel, one launch per score). Phases, each
printed on lines of its own:

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
7. train    the training path, gwm_light at full width:
            7a  K3 against its plain version on the card, counts equal,
                over 2/3/50/104 classes, 256^3, (31, 33, 17) and a batch of
                2 at that shape, int32/int64 label pairs, labels -1, C and
                2^30 among them and one class absent; ops.dice bit-equal to
                dice_from_counts of the plain counts;
            7b  one train step at 64^3, batch 2, dropout 0, on the card and
                on the CPU from the same params and batch: loss, ce,
                soft_dice_loss and grad_norm within 1e-4 relative, the hard
                Dice equal (where both argmaxes agree), every gradient leaf
                but the pre-BN conv biases within 1e-4 of the global norm;
            7c  the main path: trainer.train at 256^3, batch 1, dropout 0.1,
                8 steps, a checkpoint, evaluate on 2 held-out subjects;
                every launch count set to 0 just before and read just
                after: K3 exactly 8 + 2 times, K1 exactly 9 x 2, K2 never;
                metrics finite; the checkpoint restores equal;
            7d  CUDA-event medians: K3 on a 256^3 3-class pair (kernel,
                plain, torch.bincount of the confusion pairs, bound), a
                256^3 train step split into forward + loss, backward,
                optimizer + BN fold and the Dice metric, its peak memory;
                one more step under torch.profiler (device time by
                kernel); one conv layer's weight gradient alone
            7e  the kernels line: one JSON line describing every ported
                kernel (K1, K2, K3)
8. ok       the last line, {"ok": true, "device": {...}}

Any failed check raises, so the script exits non-zero and prints no ok
line. Without a CUDA device (and without --cpu-rehearsal) it exits 1.
--cpu-rehearsal runs phases 1, 4, 5, 7b and 7c at a tiny size on the CPU
with the plain versions, to find wrong paths and shapes without a card; it
never prints the ok line.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import synchronize, tree  # noqa: E402
from repro_torch.core import conform, meshnet  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.data import mri  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import dice as k3  # noqa: E402
from repro_torch.kernels import dilated_conv3d as k1  # noqa: E402
from repro_torch.kernels import megakernel as k2  # noqa: E402
from repro_torch.serving.engine import SegmentationEngine  # noqa: E402
from repro_torch.training import checkpoint, losses, optimizer, trainer  # noqa: E402

KERNEL_REL_TOL = 5e-5
FORWARD_REL_TOL = 2e-4  # the fused forward (tests/test_executors.py)
MEGA_FORWARD_REL_TOL = 1e-4  # the megakernel forward (tests/test_megakernel.py)
ARGMAX_AGREE = 0.9999
TRAIN_REL_TOL = 1e-4  # card against CPU: a train step's loss terms and grad norm
GRAD_TOL = 1e-4  # card against CPU: each gradient leaf, times the global norm
TRAIN_STEPS = 8
EVAL_SUBJECTS = 2
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


def profile_step(run_step, unprofiled_ms: float) -> None:
    """Device time of one more train step by kernel, from a torch.profiler
    trace, and the share of the step the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in cuda) / 1e3
    if busy_ms == 0:
        print("profile: the profiler saw no device time; busy share not measured")
        return
    print(f"profile (train step): device busy {busy_ms:.3f} ms of a profiled step of {wall * 1e3:.3f} ms "
          f"({busy_ms / (wall * 1e3):.1%}); {busy_ms / unprofiled_ms:.1%} of the unprofiled step's {unprofiled_ms:.3f} ms; "
          f"{sum(e.count for e in cuda)} device operations")
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


def conv_weight_grad_times(dev, size: int, gen: torch.Generator) -> None:
    """The training conv's weight gradient alone (cuDNN, TF32 off), one
    5 -> 5 layer at d = 4: the forward, and the forward with the weight
    gradient, for the channels-last view the trainer passes and a
    channels-first copy, with cuDNN's autotuning off and on."""
    x = torch.randn((1, size, size, size, 5), generator=gen).to(dev)
    w = (0.2 * torch.randn((5, 5, 3, 3, 3), generator=gen)).to(dev).requires_grad_(True)
    before = torch.backends.cudnn.benchmark
    try:
        for layout, xin in (("channels-last view", x.permute(0, 4, 1, 2, 3)),
                            ("channels-first", x.permute(0, 4, 1, 2, 3).contiguous())):
            for autotune in (False, True):
                torch.backends.cudnn.benchmark = autotune
                out = F.conv3d(xin, w, padding=4, dilation=4)
                go = torch.ones_like(out)
                del out
                fwd_ms = time_ms(lambda: F.conv3d(xin, w, padding=4, dilation=4), runs=5)
                wgrad_ms = time_ms(lambda: torch.autograd.grad(F.conv3d(xin, w, padding=4, dilation=4), w, go), runs=5)
                print("times conv weight gradient " + json.dumps(dict(
                    layer="5->5 d=4", layout=layout, cudnn_benchmark=autotune, forward_ms=fwd_ms,
                    forward_and_weight_grad_ms=wgrad_ms)))
    finally:
        torch.backends.cudnn.benchmark = before


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


def dice_labels(gen: torch.Generator, shape, classes: int, dtype, device, *, absent=None, outside=True):
    """Labels in [0, C) drawn on the CPU; with ``outside`` about 2 % are -1,
    C or 2^30 (they count nowhere); class ``absent`` never occurs."""
    lab = torch.randint(0, classes, shape, generator=gen)
    if absent is not None:
        lab[lab == absent] = (absent + 1) % classes
    if outside:
        flat = lab.view(-1)
        picks = torch.nonzero(torch.rand(flat.numel(), generator=gen) < 0.02)[:, 0]
        flat[picks] = torch.tensor([-1, classes, 2**30])[torch.arange(picks.numel()) % 3]
    return lab.to(dtype).to(device)


def phase_train_parity_k3(dev) -> tuple[int, int]:
    print("== phase 7a: K3 parity against the plain version (card)")
    gen = torch.Generator().manual_seed(SEED + 71)
    shapes = [(256, 256, 256), (31, 33, 17), (2, 31, 33, 17)]
    dtypes = [(torch.int32, torch.int32), (torch.int64, torch.int32), (torch.int64, torch.int64)]
    n = worst = 0
    for classes, shape, (pdt, tdt) in itertools.product((2, 3, 50, 104), shapes, dtypes):
        absent = classes - 1
        pred = dice_labels(gen, shape, classes, pdt, dev, absent=absent)
        truth = dice_labels(gen, shape, classes, tdt, dev, absent=absent)
        got = k3.dice_counts(pred, truth, classes)
        torch.cuda.synchronize()
        expect = ref.dice_counts(pred, truth, classes)
        what = f"K3 C={classes} {shape} {str(pdt)[6:]}/{str(tdt)[6:]}"
        worst = max(worst, int((got.long() - expect.long()).abs().max()))
        check(torch.equal(got, expect), f"{what}: counts differ from the plain version")
        check(int(got[absent].abs().sum()) == 0, f"{what}: the absent class counted")
        score = ops.dice(pred, truth, classes)
        plain_score = ops.dice_from_counts(expect)
        check(bool(score.view(1).view(torch.int32) == plain_score.view(1).view(torch.int32)),
              f"{what}: ops.dice {float(score)!r} != dice_from_counts {float(plain_score)!r}")
        n += 1
        if shape[0] == 256 or classes == 104:
            print(f"{what}: counts equal; dice {float(score):.7f}")
    print(f"K3: {n} cases, counts equal to the plain version in every one")
    return n, worst


def grads_and_step(cfg, params, vol, lab, dev):
    """One train step of ``cfg`` on ``dev`` from copies of ``params`` and
    the batch: (gradients, metrics of make_train_step)."""
    params = tree.map(lambda t: t.to(dev), params)
    vol, lab = vol.to(dev), lab.to(dev)
    _, _, _, grads = trainer.loss_and_grads(params, vol, lab, cfg)
    state = optimizer.adamw_init(params, cfg.opt)
    _, _, metrics = trainer.make_train_step(cfg)(params, state, vol, lab)
    return grads, metrics


def phase_train_step_parity(dev, size: int) -> None:
    print(f"== phase 7b: one gwm_light train step at {size}^3, batch 2, on {dev.type} and on the CPU")
    cfg = trainer.TrainConfig(
        model=dataclasses.replace(meshnet.PAPER_MODELS["gwm_light"], dropout_rate=0.0),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(size,) * 3), batch_size=2, seed=SEED),
    )
    params = meshnet.init(cfg.model, generator=torch.Generator().manual_seed(SEED + 72), device="cpu")
    vol, lab = next(iter(mri.DataLoader(cfg.data, device="cpu")))
    cpu_grads, cpu_metrics = grads_and_step(cfg, params, vol, lab, torch.device("cpu"))
    grads, metrics = grads_and_step(cfg, params, vol, lab, dev)
    for k in ("loss", "ce", "soft_dice_loss", "grad_norm"):
        got, expect = float(metrics[k]), float(cpu_metrics[k])
        rel = abs(got - expect) / max(abs(expect), 1e-30)
        print(f"{k}: {dev.type} {got!r} cpu {expect!r} rel {rel:.3e}")
        check(rel <= TRAIN_REL_TOL, f"train step {k} rel err {rel} > {TRAIN_REL_TOL}")
    gnorm = float(optimizer.global_norm(cpu_grads))
    worst, worst_bias = 0.0, 0.0
    for (i, layer), cpu_layer in zip(enumerate(grads["layers"] + [grads["head"]]), cpu_grads["layers"] + [cpu_grads["head"]]):
        for name, g in layer.items():
            err = float((g.cpu() - cpu_layer[name]).abs().max()) / gnorm
            if name == "b" and i < len(grads["layers"]) and cfg.model.use_batchnorm:
                worst_bias = max(worst_bias, err)  # exact gradient 0: rounding noise
                continue
            worst = max(worst, err)
            check(err <= GRAD_TOL, f"gradient of layer {i} {name}: error {err} of the global norm > {GRAD_TOL}")
    print(f"gradients: global norm {gnorm!r}; worst leaf error {worst:.3e} of it "
          f"(pre-BN conv biases, not held: {worst_bias:.3e})")
    dice, cpu_dice = float(metrics["dice"]), float(cpu_metrics["dice"])
    if dice == cpu_dice:
        print(f"dice: {dice!r} on both")
        return
    # The Dice of equal hard labels is equal; a logit within rounding of a
    # tie can flip one voxel's argmax between the two devices.
    hard = torch.argmax(meshnet.apply_with_stats(tree.map(lambda t: t.to(dev), params), vol.to(dev), cfg.model)[0], -1)
    cpu_hard = torch.argmax(meshnet.apply_with_stats(params, vol, cfg.model)[0], -1)
    differ = int((hard.cpu() != cpu_hard).sum())
    agree = 1.0 - differ / cpu_hard.numel()
    print(f"dice: {dev.type} {dice!r} cpu {cpu_dice!r}; argmax differs on {differ} voxels ({agree:.6%} agree)")
    check(differ > 0, "the hard labels agree but the Dice does not")
    check(agree >= ARGMAX_AGREE, f"argmax agreement {agree} < {ARGMAX_AGREE}")


def phase_train(dev, size: int) -> dict:
    print(f"== phase 7c: trainer.train, gwm_light at {size}^3, batch 1, dropout 0.1, {TRAIN_STEPS} steps, "
          f"checkpoint, evaluate on {EVAL_SUBJECTS} subjects: main path of K3 (and K1)")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = trainer.TrainConfig(
        model=dataclasses.replace(meshnet.PAPER_MODELS["gwm_light"], dropout_rate=0.1),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(size,) * 3), batch_size=1, seed=SEED),
        steps=TRAIN_STEPS, eval_subjects=EVAL_SUBJECTS, log_every=1,
        ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN_STEPS, seed=SEED,
    )
    synchronize(dev)
    k1.launches = k2.launches = k3.launches = 0  # main path starts
    t0 = time.perf_counter()
    res = trainer.train(cfg, verbose=True, device=dev)
    synchronize(dev)
    wall = time.perf_counter() - t0
    counts = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches}  # main path ends
    print(f"train: {TRAIN_STEPS} steps + checkpoint + evaluate in {wall:.3f} s wall; launches {counts}; "
          f"final held-out dice {res.final_dice!r}")
    for m in res.history:
        check(all(math.isfinite(v) for v in m.values()), f"step {m['step']} metrics finite: {m}")
    check(math.isfinite(res.final_dice), "held-out dice finite")
    if dev.type == "cuda":
        expected = {"K1": len(cfg.model.dilations) * EVAL_SUBJECTS, "K2": 0, "K3": TRAIN_STEPS + EVAL_SUBJECTS}
        check(counts == expected, f"train path launched {counts}, expected {expected}")
    latest = checkpoint.latest_step_dir(str(ckpt_dir))
    restored, manifest = checkpoint.restore(latest, device=dev)
    trained = {"params": res.params, "opt_state": res.opt_state}
    pairs = list(zip(tree.leaves(restored), tree.leaves(trained)))
    check(manifest["step"] == TRAIN_STEPS and type(restored["opt_state"]) is optimizer.AdamWState,
          f"checkpoint step {manifest['step']} and state type {type(restored['opt_state']).__name__}")
    check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs), "the checkpoint restores equal")
    print(f"checkpoint {Path(latest).name}: {len(pairs)} tensors restored equal on {dev.type}")
    return {"counts": counts, "cfg": cfg, "params": res.params, "opt_state": res.opt_state}


def k3_work(n: int, classes: int, pred_bytes: int, truth_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one count: K3 reads each label once and writes
    the (C, 3) int32 counts; a few integer operations a label."""
    return 6 * n, n * (pred_bytes + truth_bytes) + 12 * classes


def phase_train_times(dev, card: str, size: int, trained: dict) -> dict:
    print(f"== phase 7d: times at the training path's shapes ({size}^3, card: {card})")
    _, peak_flops, peak_bw = peaks_for(card)
    gen = torch.Generator().manual_seed(SEED + 74)
    classes = 3
    shape = (size,) * 3
    pred = torch.randint(0, classes, shape, generator=gen).to(dev)  # int64, as argmax gives
    truth = torch.randint(0, classes, shape, generator=gen, dtype=torch.int32).to(dev)
    n = pred.numel()
    check(torch.equal(k3.dice_counts(pred, truth, classes), ref.dice_counts(pred, truth, classes)),
          "K3 on the timing pair")
    pairs = (pred * classes + truth).view(-1)  # each voxel's confusion pair, for torch.bincount
    kernel_ms = time_ms(lambda: k3.dice_counts(pred, truth, classes))
    plain_ms = time_ms(lambda: ref.dice_counts(pred, truth, classes))
    library_ms = time_ms(lambda: torch.bincount(pairs, minlength=classes * classes))
    ops_, bytes_ = k3_work(n, classes, 8, 4)
    bound_ms, bound_by = bound(ops_, bytes_, peak_flops, peak_bw)
    k3_row = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                  bound_by=bound_by, ops=ops_, bytes=bytes_, classes=classes, voxels=n)
    print("times K3 " + json.dumps(k3_row))
    del pred, truth, pairs

    cfg, params, state = trained["cfg"], trained["params"], trained["opt_state"]
    vol, lab = next(iter(mri.DataLoader(cfg.data, device=dev)))
    drop = torch.Generator(device=dev).manual_seed(SEED + 75)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    leaf_params = tree.unflatten(params, leaves)
    runs, slow_runs = 10, 5  # the backward and the whole step take seconds each

    def forward_loss():
        with meshnet.fp32_convs():
            return trainer.forward_loss(leaf_params, vol, lab, cfg, drop)

    fwd_ms = time_ms(forward_loss, runs=runs)
    events = []
    for _ in range(slow_runs + 1):
        loss, _, _ = forward_loss()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with meshnet.fp32_convs():
            start.record()
            torch.autograd.grad(loss, leaves, allow_unused=True)
            end.record()
        events.append((start, end))
        del loss
    torch.cuda.synchronize()
    bwd_ms = statistics.median(s.elapsed_time(e) for s, e in events[1:])
    _, _, stats, grads = trainer.loss_and_grads(params, vol, lab, cfg, drop)
    opt_ms = time_ms(lambda: trainer.apply_update(params, state, grads, stats, cfg), runs=runs)
    with torch.no_grad():
        logits = meshnet.apply_with_stats(params, vol, cfg.model)[0]
    dice_ms = time_ms(lambda: losses.dice_score(torch.argmax(logits, -1), lab, cfg.model.num_classes), runs=runs)
    step = trainer.make_train_step(cfg)
    step_ms = time_ms(lambda: step(params, state, vol, lab, drop), runs=slow_runs, warmup=1)
    del logits, grads, stats
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(params, state, vol, lab, drop)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_row = dict(
        volume=list(shape), batch=cfg.data.batch_size, dropout_rate=cfg.model.dropout_rate,
        forward_loss_ms=fwd_ms, backward_ms=bwd_ms, optimizer_bn_fold_ms=opt_ms, dice_metric_ms=dice_ms,
        step_ms=step_ms, peak_bytes=peak, resident_bytes_before=base,
    )
    print("times train step " + json.dumps(step_row))
    print(f"train step at {size}^3: forward + loss (Dice metric included) {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, "
          f"optimizer + BN fold {opt_ms:.3f} ms, Dice metric alone {dice_ms:.3f} ms; whole step {step_ms:.3f} ms; "
          f"peak device memory {peak / 2**30:.3f} GiB ({base / 2**20:.1f} MiB resident before)")
    profile_step(lambda: step(params, state, vol, lab, drop), step_ms)
    conv_weight_grad_times(dev, size, gen)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"after timing: clocks.sm, power.draw, power.limit, temperature: {smi.stdout.strip()}")
    return k3_row


def kernels_line(rows, seg_rows, launches: dict, k1_err, k2_err, k3_row, k3_err) -> dict:
    """Per-forward numbers of K1 and K2: one gwm_light forward at 256^3,
    9 launches of K1 or one launch of K2 per segment of the plan; K3's per
    count of one 256^3 3-class pair."""

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
            {
                "name": "dice_counts",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dice.cu",
                "replaces": "src/repro/kernels/dice.py:20",
                "tpu_kernel": "src/repro/kernels/dice.py::_dice_kernel",
                "launches": launches["train"]["K3"],
                "max_abs_err": k3_err,
                "ms": k3_row["kernel_ms"],
                "plain_ms": k3_row["plain_ms"],
                "bound_ms": k3_row["bound_ms"],
                "bound_by": k3_row["bound_by"],
                "library_ms": k3_row["library_ms"],
                "library": "torch.bincount(pred * C + truth, minlength=C * C), the confusion matrix the counts follow from",
                "per": "one 256^3 3-class count (int64 pred, int32 truth); launches from the train path "
                       f"({TRAIN_STEPS} steps + {EVAL_SUBJECTS} held-out subjects)",
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
        phase_train_step_parity(dev, 16)
        phase_train(dev, size)
        print(f"cpu rehearsal done in {time.perf_counter() - t_start:.1f} s (no ok line)")
        return 0
    rows, seg_rows = phase_times(dev, card, size)
    k3_cases, k3_err = phase_train_parity_k3(dev)
    phase_train_step_parity(dev, 64)
    trained = phase_train(dev, size)
    launches["train"] = trained["counts"]
    check(launches["train"]["K3"] > 0, "K3 was not launched on its main path")
    k3_row = phase_train_times(dev, card, size, trained)
    print(json.dumps(kernels_line(rows, seg_rows, launches, k1_err, k2_err, k3_row, k3_err)))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
