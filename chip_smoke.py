#!/usr/bin/env python3
"""Drive the PyTorch port's segmentation main path on one CUDA card.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # tiny shapes, plain paths, CPU

Phases, each printed on lines of its own:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel source of the port, timed, with
            ptxas' register and shared-memory report
3. parity   K1 (the fused dilated conv) against its plain PyTorch version
            on the card, relative error <= 5e-5 of the output's magnitude
4. forward  gwm_light at 256^3: the kernel-backed forward against the
            plain forward, logits within 2e-4 relative, argmax agreeing on
            >= 99.99 % of voxels
5. serve    SegmentationEngine.submit on 3 synthetic volumes (one raw
            shape non-cubic), brain_mask_fast as the crop model; each
            request must run executor cuda_fused and launch K1 exactly 18
            times (9 mask layers + 9 main layers). This is the main path:
            launch counts are zeroed just before it and read just after.
            One more request runs under torch.profiler: device time by
            kernel and the share of the request the card was busy.
6. times    CUDA-event medians of 20 runs at the main path's layer shapes:
            kernel, plain version, F.conv3d (TF32 off), and the bound
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
from repro_torch.serving.engine import SegmentationEngine  # noqa: E402

KERNEL_REL_TOL = 5e-5
FORWARD_REL_TOL = 2e-4
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
        report = [line for line in _build.build_log(name).splitlines() if "ptxas" in line]
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


def phase_forward(dev, size: int) -> None:
    print(f"== phase 4: gwm_light forward at {size}^3, kernel path vs plain path")
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    gen = torch.Generator().manual_seed(SEED + 4)
    params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    x = conform.conform(vol, (size,) * 3)[None]
    got = ops.meshnet_apply(params, x, cfg)
    expect = meshnet.apply(params, x, cfg)
    check(bool(torch.isfinite(got).all()), "forward logits are finite")
    check(tuple(got.shape) == (1, size, size, size, cfg.num_classes), f"logits shape {tuple(got.shape)}")
    abs_err, rel = rel_err(got, expect)
    disagree = int((got.argmax(-1) != expect.argmax(-1)).sum())
    agree = 1.0 - disagree / got[..., 0].numel()
    print(f"logits max_abs_err {abs_err:.3e} rel {rel:.3e}; argmax disagrees on {disagree} voxels ({agree:.6%} agree)")
    check(rel <= FORWARD_REL_TOL, f"forward rel err {rel} > {FORWARD_REL_TOL}")
    check(agree >= ARGMAX_AGREE, f"argmax agreement {agree} < {ARGMAX_AGREE}")


def phase_serve(dev, size: int) -> int:
    print(f"== phase 5: serve 3 requests at {size}^3 through SegmentationEngine.submit (main path)")
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
    per_request = 2 * len(cfg.dilations) if dev.type == "cuda" else 0
    synchronize(dev)
    k1.launches = 0  # main path starts
    results = []
    for i, vol in enumerate(vols):
        before = k1.launches
        t0 = time.perf_counter()
        res = engine.submit(vol)
        wall = time.perf_counter() - t0
        rec = res.record
        launched = k1.launches - before
        st = rec.times
        print(
            f"request {i} raw {tuple(vol.shape)}: status {rec.status} mode {rec.mode} executor {rec.executor} "
            f"crop {rec.crop_size} K1 launches {launched}; stage s: preprocessing {st.preprocessing:.4f} "
            f"cropping {st.cropping:.4f} inference {st.inference:.4f} postprocessing {st.postprocessing:.4f} "
            f"total {st.total():.4f}; submit wall {wall:.4f}"
        )
        check(rec.status == "ok", f"request {i} status {rec.status} ({rec.fail_type})")
        expected_exec = "cuda_fused" if dev.type == "cuda" else "torch"
        check(rec.executor == expected_exec, f"request {i} executor {rec.executor}")
        seg = res.segmentation
        check(tuple(seg.shape) == shape and seg.device.type == dev.type, f"request {i} segmentation {tuple(seg.shape)} on {seg.device}")
        check(launched == per_request, f"request {i} launched K1 {launched} times, expected {per_request}")
        results.append(res)
    main_launches = k1.launches  # main path ends
    check(dev.type != "cuda" or main_launches > 0, "K1 was not launched on the main path")

    # Hold the first request against the plain path (executor torch).
    plain = engine.submit(vols[0], executor="torch")
    check(plain.record.status == "ok" and plain.record.executor == "torch", "plain-path request")
    differ = int((plain.segmentation != results[0].segmentation).sum())
    agree = 1.0 - differ / results[0].segmentation.numel()
    labels = torch.bincount(results[0].segmentation.reshape(-1).long(), minlength=cfg.num_classes).tolist()
    print(f"request 0 vs executor torch: crop {plain.record.crop_size} vs {results[0].record.crop_size}; "
          f"{differ} voxels differ ({agree:.6%} agree); label counts {labels}")
    check(plain.record.crop_size == results[0].record.crop_size, "crop size agrees with the plain path")
    check(agree >= ARGMAX_AGREE, f"segmentation agreement {agree} < {ARGMAX_AGREE}")
    if dev.type == "cuda":
        profile_request(engine, vols[0], unprofiled_s=results[0].record.times.total())
    return main_launches


def profile_request(engine, vol, unprofiled_s: float) -> None:
    """Device time of one more request by kernel, from a torch.profiler
    trace, and the share of the request the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.submit(vol)
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # time of the kernels it launched
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in cuda) / 1e6
    if busy_s == 0:
        print("profile: the profiler saw no device time; busy share not measured")
        return
    print(
        f"profile: device busy {busy_s:.4f} s of a profiled request of {wall:.4f} s "
        f"({busy_s / wall:.1%}); {busy_s / unprofiled_s:.1%} of the unprofiled request's {unprofiled_s:.4f} s"
    )
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")


def phase_times(dev, card: str, size: int) -> list[dict]:
    print(f"== phase 6: times at the main path's layer shapes ({size}^3, card: {card})")
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
        t_ops, t_bytes = ops_ / peak_flops * 1e3, bytes_ / peak_bw * 1e3
        row = dict(
            dilation=d, cin=cin, cout=cout, launches_per_forward=count,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            ops=ops_, bytes=bytes_, library_rel_err=lib_rel,
        )
        print("times " + json.dumps(row))
        rows.append(row)
        del x, lib_out
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"after timing: clocks.sm, power.draw, power.limit, temperature: {smi.stdout.strip()}")
    return rows


def kernels_line(rows, launches: int, max_abs: float, max_rel: float) -> dict:
    """Per-forward numbers of K1 (one gwm_light forward: 9 launches)."""
    total = {k: sum(r[k] * r["launches_per_forward"] for r in rows) for k in ("kernel_ms", "plain_ms", "library_ms")}
    t_ops = sum(r["bound_ms"] * r["launches_per_forward"] for r in rows if r["bound_by"] == "operations")
    t_bytes = sum(r["bound_ms"] * r["launches_per_forward"] for r in rows if r["bound_by"] == "bytes")
    return {
        "kernels": [
            {
                "name": "dilated_conv3d",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dilated_conv3d.cu",
                "replaces": "src/repro/kernels/dilated_conv3d.py:62",
                "tpu_kernel": "src/repro/kernels/dilated_conv3d.py::_halo_kernel",
                "launches": launches,
                "max_abs_err": max_abs,
                "max_rel_err": max_rel,
                "ms": total["kernel_ms"],
                "plain_ms": total["plain_ms"],
                "bound_ms": t_ops + t_bytes,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": total["library_ms"],
                "per": "one gwm_light forward at 256^3 (9 launches); sums of per-layer medians",
            }
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
        max_abs, max_rel = phase_parity(dev)
    phase_forward(dev, size)
    launches = phase_serve(dev, size)
    if rehearsal:
        print(f"cpu rehearsal done in {time.perf_counter() - t_start:.1f} s (no ok line)")
        return 0
    rows = phase_times(dev, card, size)
    print(json.dumps(kernels_line(rows, launches, max_abs, max_rel)))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
