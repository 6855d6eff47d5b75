#!/usr/bin/env python3
"""Time variants of K1r (csrc/dilated_conv3d_lp.cu, the tensor-core conv
at bf16 and int8w) at gwm_light's layer shapes at 256^3, to see what holds
the kernel back.

    python3 tools/k1r_variants.py [variant ...]   # on a machine with an NVIDIA card and nvcc

Each variant is the kernel's source with one edit, built by nvcc into
build/k1r_variants/<name>/ (git-ignored), all builds at once, and called
through its C entry point, each variant in a process of its own (240 s at
most), on the same inputs: a bf16 post-ReLU volume and
bf16 weights, gwm_light's 1 -> 5 layer (d = 1) and its 5 -> 5 layers at d
= 1, 2, 4, 8 and 16, fused epilogue. Times are chip_smoke.time_ms's
CUDA-event medians of a call (chip_smoke.device_ms's device time of 10
calls back to back beside the kernel's), the same yardstick as every
kernel row of chip_smoke.py; each variant's registers and spills from
ptxas; the forward sum weights each layer by its launches in a gwm_light
forward (1 -> 5 once, 5 -> 5 at d = 1, 2, 4, 8 twice... as its dilations
say). The card's clocks and power are read after each variant. Variants:

  kernel       the source as it is
  no_copy      no input copies (the layout reads whatever the raw buffer holds)
  no_layout    no layout of the copied rows (the mmas read whatever the rows hold)
  no_mma       no mma (a cheap use of the operands keeps their loads)
  no_ldsm      no ldmatrix (the A operands are their addresses)
  no_epilogue  no epilogue: the accumulators only summed (so that ptxas
               keeps the mmas that feed them), nothing written
  no_store     the epilogue without its 16-byte stores to device memory
  no_pack      the epilogue without its writes of the output rows to shared memory
  blocks_3     at least 3 blocks an SM (168 registers a thread) instead of 4
  no_bw1       the B fragments of tap +1 read from shared memory at each
               use instead of kept in registers
  no_prefetch  a tile's copies issued and waited for at its start, not
               during the previous tile's mmas
  phases       the source with clock64() stamps: each warp's cycles a tile
               in the wait for its copies, its layout, the next tile's
               copies, the barrier after them, the mmas, the epilogue and the barrier
               after it (the cycles of every warp and tile, divided by the
               warps' tiles)
  mt_2         tiles of 32 voxels along x at C = 5 instead of 64

The ablations compute wrong numbers on purpose; only their times mean
anything. Nothing here is imported by the port.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import meshnet  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k1r_variants"
SIZE = 256
MMA = '''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));'''
LDSM = '''  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");'''
PREFETCH = "      if (g.mode == kRaw) copy_raw(Tn, ro_n);\n"
WAIT = "      while (!mbar_done(bar, phase)) {  // this tile's copies, issued during the previous tile's mmas\n"

# name -> (edits to dilated_conv3d_lp.cu, numbers right?)
VARIANTS = {
    "kernel": ((), True),
    "no_copy": ((("        if (ge > gs)\n          bulk_copy(", "        if (ge < 0)\n          bulk_copy("),
                 ("        bytes += ge > gs ? 16 * cin * (ge - gs) : 0;", "        bytes += 0;")), False),
    "no_layout": ((("        for (int i = lane; i < nws * np; i += 32) {", "        for (int i = lane; i < 0; i += 32) {"),),
                  False),
    "blocks_3": ((("__global__ void __launch_bounds__(32 * kMaxWarps, C <= 8 ? 4 : 3)",
                   "__global__ void __launch_bounds__(32 * kMaxWarps, 3)"),), True),
    "no_bw1": ((("                    mma1688(acc[iz][jy][ml][0], a1[ml], bw1[tz * 3 + ty]);",
                 "                    mma1688(acc[iz][jy][ml][0], a1[ml], frag[((tz * 3 + ty) * 2 + 1) * 32 + lane].x);"),
                ("            bw1[tr] = frag[(tr * 2 + 1) * 32 + lane].x;\n", "")), True),
    "no_mma": (((MMA, "  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b.x ^ b.y) & 0x007fffffu);"),), False),
    "no_ldsm": (((LDSM, "  a[0] = addr; a[1] = addr + 1; a[2] = addr + 2; a[3] = addr + 3;"),), False),
    "no_epilogue": ((("  const int g8 = lane >> 2, q = lane & 3;\n  const uintptr_t lo",
                      "  float sum = 0.0f;\n#pragma unroll\n  for (int mt = 0; mt < MTS; ++mt)\n#pragma unroll\n"
                      "    for (int nt = 0; nt < NT; ++nt)\n#pragma unroll\n      for (int e = 0; e < 4; ++e) sum += a[mt][nt][e];\n"
                      "  if (sum != 12345.0f) return;\n  const int g8 = lane >> 2, q = lane & 3;\n  const uintptr_t lo"),),
                    False),
    "no_store": ((("      *reinterpret_cast<uint4*>(ga) = *reinterpret_cast<const uint4*>(src);",
                   "      if (ga == 8) *reinterpret_cast<uint4*>(ga) = *reinterpret_cast<const uint4*>(src);"),), False),
    "no_pack": ((("        o16[v * C + n] = bf16_bits(", "        if (a[mt][nt][e] == -1.0f) o16[v * C + n] = bf16_bits("),),
                False),
    "no_prefetch": (((PREFETCH, ""), (WAIT, "      if (tile != blockIdx.x) copy_raw(T, ro_l);\n" + WAIT)), True),
    "phases": ((("    T = Tn, ro_l = ro_n;\n  }\n}\n",
                 "    T = Tn, ro_l = ro_n;\n  }\n"
                 "  if (lane == 0) for (int i = 0; i < 8; ++i) atomicAdd(&k1r_phase_cycles[i], cyc[i]);\n}\n"),
                ("    Tl Tn{};\n", "    ph1b = clock64();\n    Tl Tn{};\n"),
                ("    const int b = T.b, z0 = T.z0,",
                 "    const long long ph0 = clock64();\n    long long ph4 = 0, ph1b = 0;\n    const int b = T.b, z0 = T.z0,"),
                ("    __syncwarp();\n    if (g.mode == kRaw && (cin == 5",
                 "    const long long ph1 = clock64();\n    __syncwarp();\n    if (g.mode == kRaw && (cin == 5"),
                ("    __syncthreads();\n\n    const float clamp_lo",
                 "    const long long ph2 = clock64();\n    __syncthreads();\n    const long long ph3 = clock64();\n"
                 "\n    const float clamp_lo"),
                ("#pragma unroll\n          for (int iz = 0; iz < 2; ++iz)\n#pragma unroll\n            for (int jy = 0; jy < 2; ++jy)\n              if (zp",
                 "          ph4 = clock64();\n#pragma unroll\n          for (int iz = 0; iz < 2; ++iz)\n#pragma unroll\n"
                 "            for (int jy = 0; jy < 2; ++jy)\n              if (zp"),
                ("    __syncthreads();  // the next tile's layout overwrites the rows\n",
                 "    const long long ph5 = clock64();\n    __syncthreads();\n    const long long ph6 = clock64();\n"
                 "    if (ph4 == 0) ph4 = ph5;\n"
                 "    cyc[0] += ph1 - ph0; cyc[1] += ph1b - ph1; cyc[7] += ph2 - ph1b; cyc[2] += ph3 - ph2;\n"
                 "    cyc[3] += ph4 - ph3; cyc[4] += ph5 - ph4; cyc[5] += ph6 - ph5; cyc[6] += 1;\n"),
                ("  unsigned phase = 0;", "  unsigned long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  unsigned phase = 0;"),
                ("namespace {\n", "__device__ unsigned long long k1r_phase_cycles[8];\n"
                 "extern \"C\" int k1r_phase_read(unsigned long long* out, int reset) {\n"
                 "  cudaError_t e = cudaMemcpyFromSymbol(out, k1r_phase_cycles, sizeof(k1r_phase_cycles));\n"
                 "  if (reset) { unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                 "    e = cudaMemcpyToSymbol(k1r_phase_cycles, z, sizeof(z)); }\n"
                 "  return (int)e;\n}\nnamespace {\n")), True),
    "mt_2": ((("static constexpr int MT = C <= 8 ? 4 :", "static constexpr int MT = C <= 8 ? 2 :"),
              ("mt0 = C <= 8 ? 4 :", "mt0 = C <= 8 ? 2 :"),
              ("case 5: return mt == 4 ? f.template operator()<5, 4, WT>()",
               "case 5: return mt == 2 ? f.template operator()<5, 2, WT>()")), True),
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    return text


def build(names, compile: bool = True) -> dict:
    """The variants' libraries, built by nvcc all at once (``compile``) or
    loaded as an earlier call built them."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in names if compile else ():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "dilated_conv3d_lp.cu").write_text(edited((CSRC / "dilated_conv3d_lp.cu").read_text(), VARIANTS[name][0]))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "dilated_conv3d_lp.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"built {name}: " + "; ".join(ptxas_report(log)), flush=True)
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.repro_dilated_conv3d_lp.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.repro_dilated_conv3d_lp.restype = ctypes.c_int
        if name == "phases":
            lib.k1r_phase_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    return libs


def ptxas_report(log: str) -> list:
    """Per kernel instantiation (its template arguments): registers and spill
    bytes, from ptxas's -v output."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("k1r_kernel")[-1].split("EEvPK")[0] if "k1r_kernel" in line else None
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name} {line.split('Used')[1].split(',')[0].strip()}, {spill} B spilled")
            name = None
    return out


def layer_counts() -> dict:
    """(cin, d) -> launches in one gwm_light forward."""
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    counts, cin = {}, cfg.in_channels
    for d in cfg.dilations:
        counts[(cin, d)] = counts.get((cin, d), 0) + 1
        cin = cfg.channels
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("k1r_variants: no CUDA device is available", file=sys.stderr)
        return 1
    names = [n for n in VARIANTS if len(sys.argv) == 1 or n in sys.argv[1:]]
    if len(names) > 1:
        # build every variant at once, then time each in a process of its
        # own, so that one that hangs (an ablation may) stops only itself
        smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        print("card: " + subprocess.run(smi, capture_output=True, text=True).stdout.strip(), flush=True)
        build(names)
        for name in names:
            try:
                subprocess.run([sys.executable, __file__, name, "--built"], timeout=240, check=False)
            except subprocess.TimeoutExpired:
                print(f"{name}: did not finish within 240 s", flush=True)
        return 0
    libs = build(names, compile="--built" not in sys.argv)
    gen = torch.Generator().manual_seed(0)
    counts = layer_counts()
    inputs = {}
    for cin, d in sorted(counts, key=lambda k: (k[0], k[1])):
        x, w, b, s, o = chip_smoke.reduced_inputs(gen, (1, SIZE, SIZE, SIZE), cin, 5, False, "cuda")
        inputs[(cin, d)] = (x, w, b, s, o, torch.empty((1, SIZE, SIZE, SIZE, 5), dtype=torch.bfloat16, device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    for name in names:
        fn = libs[name].repro_dilated_conv3d_lp
        row, forward = [], 0.0
        for (cin, d), (x, w, b, s, o, out) in inputs.items():
            args = (x.data_ptr(), w.data_ptr(), 0, b.data_ptr(), s.data_ptr(), o.data_ptr(), out.data_ptr(),
                    1, SIZE, SIZE, SIZE, cin, 5, d, 1, stream)

            def call():
                err = fn(*args)
                if err:
                    raise RuntimeError(f"{name} failed to launch at {cin}->5 d={d}: error {err}")

            call()
            torch.cuda.synchronize()
            if VARIANTS[name][1] and (cin, d) in ((1, 1), (5, 2)):
                expect = ref.dilated_conv3d(x[:, :40], w, b, dilation=d, scale=s, offset=o, fuse_affine=True)[:, :38]
                err = float((out[:, :38].float() - expect.float()).abs().max())
                row.append(f"max_abs_err {err:.3e} (one bf16 step {2.0**-8 * float(expect.float().abs().max()):.3e})")
            ms, dev_ms = chip_smoke.time_ms(call), chip_smoke.device_ms(call)
            forward += counts[(cin, d)] * ms
            row.append(f"{cin}->5 d={d}: {ms:.4f} ms (device {dev_ms:.4f})")
            if name == "phases":
                cyc = (ctypes.c_ulonglong * 8)()
                libs[name].k1r_phase_read(cyc, 1)
                call()
                torch.cuda.synchronize()
                libs[name].k1r_phase_read(cyc, 1)
                parts = ((0, "wait"), (1, "layout"), (7, "next copies"), (2, "barrier"), (3, "mma"),
                         (4, "epilogue"), (5, "barrier"))
                row.append("cycles a warp's tile: " + ", ".join(f"{p} {cyc[i] / max(cyc[6], 1):.0f}" for i, p in parts))
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip()
        print(f"{name}: " + " | ".join(row) + f" | forward {forward:.4f} ms | after: {clocks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
