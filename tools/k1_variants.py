#!/usr/bin/env python3
"""Time variants of K1 (csrc/dilated_conv3d.cu on csrc/conv_tile.cuh) at
the main path's 256^3 layer shapes, to see what holds the kernel back.

    python3 tools/k1_variants.py [variant ...]   # on a machine with an NVIDIA card and nvcc

Each variant is the kernel's source with one edit, built by nvcc into
build/k1_variants/<name>/ (git-ignored), all builds at once, and called
through its C entry point on the same inputs: gwm_light's 1 -> 5 layer
(d = 1) and its 5 -> 5 layers at d = 2 and 16, fused epilogue. Printed:
CUDA-event medians of 20 calls, the card's clocks and power after each
variant, and each kept variant's max error against the plain version on
a slab of the d = 2 output. Variants:

  kernel         the source as it is
  no_copy        no copies (the FFMAs read whatever the ring holds)
  no_fma         no FFMAs (the copies and the loop remain)
  no_copy_no_w   no copies, and constant weights in place of the weight loads
  no_copy_no_in  no copies, and constant inputs in place of the input loads
  stages_3       three ring slots a warp instead of two
  rows_1         one output row a warp instead of two (C = 5)
  regs_128       at most 128 registers a thread (4 blocks an SM)
  ci_unrolled    the channel loop unrolled (more code, the same work)
  cin_runtime    the channel count read at run time at C = 5 too

The ablations compute wrong numbers on purpose; only their times mean
anything. Nothing here is imported by the port.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k1_variants"
W_LOAD = "          const float4 f = *reinterpret_cast<const float4*>(pw + 4 * q);"
IN_LOAD = "      for (int k = 0; k < R; ++k) v[k] = pk[k][ci];"

# name -> (edits to conv_tile.cuh, edits to dilated_conv3d.cu, numbers right?)
VARIANTS = {
    "kernel": ((), (), True),
    "no_copy": ((("#ifdef CONV_TILE_NO_COPY", "#if 1"),), (), False),
    "no_fma": ((("#ifdef CONV_TILE_NO_FMA", "#if 1"),), (), False),
    "no_copy_no_w": ((("#ifdef CONV_TILE_NO_COPY", "#if 1"),
                      (W_LOAD, "          const float4 f = make_float4(0.1f * q + 0.01f * ci, 0.2f * t, 0.3f, 0.4f + m);")),
                     (), False),
    "no_copy_no_in": ((("#ifdef CONV_TILE_NO_COPY", "#if 1"),
                       (IN_LOAD, "      for (int k = 0; k < R; ++k) v[k] = 0.5f * k + ci;")), (), False),
    "stages_3": ((("constexpr int kStages = 2;", "constexpr int kStages = 3;"),), (), True),
    "rows_1": ((("M = C <= 10 ? 2 : 1;", "M = 1;"),), (("m = cout <= 10 ? 2 : 1;", "m = 1;"),), True),
    "regs_128": ((), (("__launch_bounds__(conv_tile::kThreads)", "__launch_bounds__(conv_tile::kThreads, 4)"),), True),
    "ci_unrolled": ((("#pragma unroll 1  // unrolled,", "#pragma unroll  // unrolled,"),), (), True),
    "cin_runtime": ((), (("  if (C != 5) return dilated_conv3d_kernel<C, 0>;", "  return dilated_conv3d_kernel<C, 0>;"),), True),
}
CASES = ((1, 5, 1), (5, 5, 2), (5, 5, 16))  # (cin, cout, dilation)
SIZE = 256


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    return text


def build() -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, (tile_edits, k1_edits, _) in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "conv_tile.cuh").write_text(edited((CSRC / "conv_tile.cuh").read_text(), tile_edits))
        (d / "dilated_conv3d.cu").write_text(edited((CSRC / "dilated_conv3d.cu").read_text(), k1_edits))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "dilated_conv3d.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":")[-1].strip() for line in log.splitlines() if "Used" in line or "spill" in line]
        print(f"built {name}: " + " | ".join(regs))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.repro_dilated_conv3d_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def time_ms(fn, runs: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(x.elapsed_time(y) for x, y in events)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print("card: " + subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    libs = build()
    gen = torch.Generator().manual_seed(0)
    inputs = {}
    for cin, cout, d in CASES:
        x = torch.randn((1, SIZE, SIZE, SIZE, cin), generator=gen).cuda()
        w = (torch.randn((3, 3, 3, cin, cout), generator=gen) * (2.0 / (27 * cin)) ** 0.5).cuda()
        b, s, o = (0.1 * torch.randn(cout, generator=gen)).cuda(), (0.5 + torch.rand(cout, generator=gen)).cuda(), \
            (0.1 * torch.randn(cout, generator=gen)).cuda()
        inputs[(cin, cout, d)] = (x, w, b, s, o, torch.empty((1, SIZE, SIZE, SIZE, cout), device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        if len(sys.argv) > 1 and name not in sys.argv[1:]:
            continue
        row = []
        for (cin, cout, d), (x, w, b, s, o, out) in inputs.items():
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), o.data_ptr(), out.data_ptr(),
                    1, SIZE, SIZE, SIZE, cin, cout, d, 1, stream)
            fn = lib.repro_dilated_conv3d_f32
            if fn(*args) != 0:
                raise RuntimeError(f"{name} failed to launch at {cin}->{cout} d={d}")
            torch.cuda.synchronize()
            if VARIANTS[name][2] and (cin, d) == (5, 2):
                expect = ref.dilated_conv3d(x[:, :40], w, b, dilation=d, scale=s, offset=o, fuse_affine=True)[:, :38]
                err = float((out[:, :38] - expect).abs().max() / expect.abs().max())
                row.append(f"rel err {err:.1e}")
            row.append(f"{cin}->{cout} d={d}: {time_ms(lambda: fn(*args)):.4f} ms")
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip()
        print(f"{name}: " + " | ".join(row) + f" | after: {clocks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
