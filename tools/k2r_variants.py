#!/usr/bin/env python3
"""Time variants of K2r (csrc/megakernel_lp.cu, the tensor-core megakernel
at bf16) on one-layer 5 -> 5 segments of a 256^3 volume, to see what holds
the kernel back.

    python3 tools/k2r_variants.py [variant ...]   # on a machine with an NVIDIA card and nvcc

Each variant is the kernel's source with one edit, built by nvcc into
build/k2r_variants/<name>/ (git-ignored), all builds at once, and called
through its C entry point on the same bf16 staging arrays (K2r's layout,
megakernel.staging_empty) and weights: a segment of one 5 -> 5 layer at
d = 2, 8 and 16 on the tile the planner gives it at bf16, and, for the
source as it is, the same layers on other tiles. Printed: CUDA-event
medians of 20 launches, the card's clocks and power after each variant.
Variants:

  kernel     the source as it is
  no_copy    no input copies (the mmas read whatever the ring holds)
  no_wait    no wait for the copies (the ring is read while it fills)
  no_mma     no mma (a cheap use of the operands keeps their loads)
  no_layout  no layout of the staged spans into the A buffers
  no_ldsm    no ldmatrix (the A operands are their addresses)
  no_epilogue no epilogue (nothing is written)
  stages_6   six input rows in flight a warp instead of three
  blocks_3   at least 3 blocks an SM (168 registers a thread) instead of 4
  blocks_2   at least 2 blocks an SM (255 registers a thread)
  lean       only the path of a one-layer segment from and to bf16 staging
             of several channels compiled (the others' code left out)
  no_store   no output stores
  rows_3     items of 3 output rows at C = 5 instead of 2 (48 accumulators a lane)
  rows_4     items of 4 output rows at every width (64 accumulators a lane at C = 5)
  mt_2       items of 2 m16 tiles (32 voxels) at C = 5 instead of 4
  mt_3       items of 3 m16 tiles (48 voxels) at C = 5
  rows_4_mt_2      items of 4 rows of 2 m16 tiles at C = 5
  rows_4_blocks_3  items of 4 rows, at least 3 blocks an SM

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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import megakernel as mk  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "k2r_variants"
COPY = "for (int i = lane; i < ng; i += 32) cp_async16("
ZFILL = "for (int i = lane; i < n_span * cg; i += 32) {"
MMA = '''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));'''
LAYOUT = "for (int p = lane; p < n_span; p += 32) {"
LDSM = '''  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");'''
EPILOGUE = "        if (cur.tz == 2 && cur.j == cur.it.meff) epilogue(cur.it);\n"

MT4 = "static constexpr int MT = C <= 8 ? 4 : C <= 16 ? 2 : 1;"
ROWS = "static constexpr int M = C <= 8 ? 2 : C <= 16 ? 3 : 4;"
BOUNDS = "__global__ void __launch_bounds__(kThreads, 4)"

# name -> (edits to megakernel_lp.cu, input rows in flight a warp[, m16 tiles an item at C = 5])
VARIANTS = {
    "kernel": ((), 3),
    "no_copy": (((COPY, "for (int i = lane; i < 0; i += 32) cp_async16("),
                 (ZFILL, "for (int i = lane; i < 0; i += 32) {")), 3),
    "no_wait": ((("        conv_tile::cp_async_wait<kStages - 1>();\n", ""),), 3),
    "no_mma": (((MMA, "  c[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b.x ^ b.y) & 0x007fffffu);"),), 3),
    "no_layout": (((LAYOUT, "for (int p = lane; p < 0; p += 32) {"),), 3),
    "no_ldsm": (((LDSM, "  a[0] = addr; a[1] = addr + 1; a[2] = addr + 2; a[3] = addr + 3;"),), 3),
    "no_epilogue": (((EPILOGUE, ""),), 3),
    "no_store": ((("                *reinterpret_cast<uint32_t*>(gdst + v * opos",
                   "                if (v < 0) *reinterpret_cast<uint32_t*>(gdst + v * opos"),), 3),
    "stages_6": ((("constexpr int kStages = 3;", "constexpr int kStages = 6;"),), 6),
    "blocks_3": (((BOUNDS, "__global__ void __launch_bounds__(kThreads, 3)"),), 3),
    "blocks_2": (((BOUNDS, "__global__ void __launch_bounds__(kThreads, 2)"),), 3),
    "lean": ((("const bool direct = sizeof(XT) == 2 && g.cin > 1;", "constexpr bool direct = true;"),
              ("const bool row_buffer = g.classes > 0 || out_int8;", "constexpr bool row_buffer = false;"),
              ("    const bool last = l == g.k - 1;", "    constexpr bool last = true;")), 3),
    "rows_3": (((ROWS, "static constexpr int M = C <= 16 ? 3 : 4;"),), 3),
    "rows_4": (((ROWS, "static constexpr int M = 4;"),), 3),
    "mt_3": (((MT4, "static constexpr int MT = C <= 8 ? 3 : C <= 16 ? 2 : 1;"),), 3, 3),
    "rows_4_mt_2": (((ROWS, "static constexpr int M = 4;"),
                     (MT4, "static constexpr int MT = C <= 8 ? 2 : C <= 16 ? 2 : 1;")), 3, 2),
    "rows_4_blocks_3": (((ROWS, "static constexpr int M = 4;"),
                         (BOUNDS, "__global__ void __launch_bounds__(kThreads, 3)")), 3),
    "mt_2": (((MT4, "static constexpr int MT = C <= 8 ? 2 : C <= 16 ? 2 : 1;"),), 3, 2),
}
DILATIONS = (2, 8, 16)
TILES = ((16, 16, 256), (16, 32, 64), (8, 64, 64), (4, 8, 256), (4, 8, 192), (8, 8, 96))
SIZE = 256


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    return text


def build(names) -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(CSRC / "conv_tile.cuh", d / "conv_tile.cuh")
        (d / "megakernel_lp.cu").write_text(edited((CSRC / "megakernel_lp.cu").read_text(), VARIANTS[name][0]))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "megakernel_lp.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = sorted({line.split(":")[-1].strip() for line in log.splitlines() if "Used" in line})
        spills = max(int(line.split("bytes spill stores")[0].split(",")[-1]) for line in log.splitlines()
                     if "spill stores" in line)
        print(f"built {name}: most spill stores {spills} bytes; " + " | ".join(regs))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = lib.repro_megakernel_segment_bf16
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
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


def launcher(lib, d: int, tile: tuple, stages: int, mt: int = 0, *, gen: torch.Generator):
    """A call of the variant on one 5 -> 5 bf16 layer at dilation d over a
    256^3 volume on ``tile``, every operand made once."""
    seg = mk.Segment(1, (d,), 5, 5, tile)
    pln = mk.MegakernelPlan((seg,), (SIZE,) * 3, (2, 2, 2, 2))
    shape = (1,) + tuple(p + 2 * d for p in pln.padded(seg)) + (5,)
    x = mk.staging_empty(shape, torch.bfloat16, "cuda")
    x.copy_(torch.rand(shape, generator=gen).to(torch.bfloat16))
    w = (torch.randn((3, 3, 3, 5, 5), generator=gen) * 0.2).to(torch.bfloat16).cuda()
    vec = torch.cat([0.1 * torch.randn(5, generator=gen), 0.5 + torch.rand(5, generator=gen),
                     0.1 * torch.randn(5, generator=gen), torch.ones(10)]).cuda()
    out = mk.staging_empty((1,) + pln.out_dims(0) + (5,), torch.bfloat16, "cuda")
    # the variant's ring and item width in the layout it checks
    kept = mk.LP_STAGES, mk._lp_blocking
    mk.LP_STAGES = stages
    if mt:
        mk._lp_blocking = lambda c: (kept[1](c)[0], mt, -(-c // 8), 16 * mt)
    try:
        geom = mk.geometry(shape, pln, 0)
    finally:
        mk.LP_STAGES, mk._lp_blocking = kept
    g = (ctypes.c_int * len(geom))(*geom)
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.repro_megakernel_segment_bf16
    args = (x.data_ptr(), 0, w.data_ptr(), None, vec.data_ptr(), out.data_ptr(), 0, 0, g, len(geom), stream)
    keep = (x, w, vec, out, g)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: {lib.repro_megakernel_lp_error_string(err)}")
        return keep

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("k2r_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    print("card: " + subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    names = [n for n in VARIANTS if len(sys.argv) == 1 or n in sys.argv[1:]]
    libs = build(names)
    for lib in libs.values():
        lib.repro_megakernel_lp_error_string.restype = ctypes.c_char_p
    planned = mk.plan((1, 2, 4, 8, 16, 8, 4, 2, 1), 1, 5, 3, (SIZE,) * 3, precision="bf16")
    tile_of = {seg.dilations[0]: seg.tile for seg in planned.segments[1:]}
    for name in names:
        gen = torch.Generator().manual_seed(0)
        row = []
        for d in DILATIONS:
            tiles = [tile_of[d]] + ([t for t in TILES if t != tile_of[d]] if name == "kernel" else [])
            for tile in tiles:
                call = launcher(libs[name], d, tile, *VARIANTS[name][1:], gen=gen)
                row.append(f"d={d} tile {tile}: {time_ms(call):.4f} ms")
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip()
        print(f"{name}: " + " | ".join(row) + f" | after: {clocks}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
