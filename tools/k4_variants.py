#!/usr/bin/env python3
"""Time variants of K4 (csrc/decode_attention.cu) at the served shape, to
see where a call's time goes.

    python3 tools/k4_variants.py [--old-src PATH]   # on a machine with an NVIDIA card and nvcc

Each variant is the kernel's source with one edit that ends the kernel
early, built by nvcc into build/k4_variants/<name>/ (git-ignored), all
builds at once, and called through its C entry point on the same inputs:
TinyLlama's decode attention (B 4, H 32, KV 4, hd 64, S 1024, fp32) at
pos 255 and 1023 and at several chunk counts (``nsplit``), pos a host
int. Printed: the device time of one call with a cold L2
(``chip_smoke.cold_ms``, CUDA events around the call after a 256 MiB
write and a spin kernel) and, for the whole kernel, its max error
against the plain version. Variants, each a prefix of the one after:

  empty     returns once the block has its chunk: launch and timing alone
  copies    its first tile's K and V copies issued and waited for
  tile      every tile of the warp computed (the state kept live)
  no_merge  the 4 warps merged and the block's partial written, no count
  kernel    the source as it is

``--old-src`` names another checkout's csrc/decode_attention.cu with the
previous C entry point (q, k, v, out, part, bf16, B, S, KV, G, hd,
n_valid, nsplit, chunk, stream) and a host chunk split, such as the
earlier two-launch kernel, to time beside it. The early returns compute wrong
numbers on purpose; only their times mean anything. Nothing here is
imported by the port.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "decode_attention.cu"
OUT = ROOT / "build" / "k4_variants"
CHUNK = "  const int64_t row = (int64_t)KV * hd;  // elements between two slots\n"
COPIES = "#pragma unroll\n  for (int t = 0; t < kStages - 1; ++t) issue(t);\n"
TILES = "  cp_async_wait<0>();\n  __syncwarp();\n\n  // This warp's accumulators"
COUNT = "  if (nsplit == 1) return;\n\n  // Count in"
VARIANTS = {
    "empty": ((CHUNK, "  if (nsplit > 0) return;\n" + CHUNK),),
    "copies": ((COPIES, COPIES + "  cp_async_wait<0>();\n  if (nsplit > 0) return;\n"),),
    "tile": ((TILES, "  cp_async_wait<0>();\n  __syncwarp();\n"
                     "  if (nsplit > 0) { if (acc[0][0] + m[0] + l[0] == 12345.f) a.count[0] = 1; return; }\n\n"
                     "  // This warp's accumulators"),),
    "no_merge": ((COUNT, "  return;\n\n  // Count in"),),
    "kernel": (),
}
B, H, KV, HD, S = 4, 32, 4, 64, 1024
POSITIONS = (255, 1023)
SPLITS = (4, 8, 16)


def edited(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit no longer matches the source: {old!r}")
        text = text.replace(old, new)
    return text


def build(old_src) -> dict:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    sources = {name: edited(SOURCE.read_text(), edits) for name, edits in VARIANTS.items()}
    if old_src is not None:
        sources["old"] = Path(old_src).read_text()
    procs = {}
    for name, text in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_attention.cu").write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "decode_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        ints = 9 if name == "old" else 8
        lib.repro_decode_attention.argtypes = [ctypes.c_void_p] * (5 if name == "old" else 7) + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old-src", help="another checkout's csrc/decode_attention.cu (the two-launch entry point)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(args.old_src)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(dev) for s in ((B, 1, H, HD), (B, S, KV, HD), (B, S, KV, HD)))
    out = torch.empty_like(q)
    G = H // KV
    part = torch.empty(B * KV * max(SPLITS) * (G * HD + 16), device=dev)
    count = torch.zeros(B * KV, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for pos in POSITIONS:
        expect = ref.decode_attention(q, k, v, pos)
        if "old" in libs:
            n = pos + 1
            want = max(1, min(math.ceil(n / 64), math.ceil(264 / (B * KV))))
            chunk = math.ceil(n / want)
            split = math.ceil(n / chunk)

            def old():
                err = libs["old"].repro_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                         part.data_ptr(), 0, B, S, KV, G, HD, n, split, chunk, stream)
                assert err == 0, err

            old()
            torch.cuda.synchronize()
            print(f"pos {pos} old ({split} chunks, two launches): cold {chip_smoke.cold_ms(old):.5f} ms, "
                  f"max_abs_err {float((out - expect).abs().max()):.3e}")
        for splits in SPLITS:
            row = []
            for name, lib in libs.items():
                if name == "old":
                    continue

                def call():
                    err = lib.repro_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                                     part.data_ptr(), count.data_ptr(), None, pos, 0, B, S, KV, G, HD,
                                                     splits, stream)
                    assert err == 0, err

                count.zero_()
                row.append(f"{name} {chip_smoke.cold_ms(call):.5f}")
                if name == "kernel":
                    count.zero_()
                    call()
                    torch.cuda.synchronize()
                    row.append(f"max_abs_err {float((out - expect).abs().max()):.3e}")
            print(f"pos {pos} nsplit {splits} ({splits * KV * B} blocks), cold ms: " + ", ".join(row))
    chip_smoke.print_clocks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
