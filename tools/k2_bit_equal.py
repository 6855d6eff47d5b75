#!/usr/bin/env python3
"""Check that K2 and K2r give the same bits as another checkout's, on
seeded inputs, to show that a change to csrc/megakernel.cu or
csrc/megakernel_lp.cu left the kernels' results as they were.

    python3 tools/k2_bit_equal.py --src OTHER/src --save build/k2_bits.pt   # the other checkout's kernels
    python3 tools/k2_bit_equal.py --src src --compare build/k2_bits.pt      # this checkout's, against them

on a machine with an NVIDIA card and nvcc. Each run imports ``repro_torch``
from ``--src`` (so each builds its own kernels, under its checkout's
build/) and runs, with every tensor made from seed 0 on the card:
gwm_light's forward at 256^3 through ``cuda_megakernel`` at fp32, bf16
and int8w (K2, K2r a segment of the planner's plans), and a gwm_light
forward at (2, 37, 45, 29) on a plan forced to several multi-layer
segments by a 40,000-byte shared-memory budget at fp32 (K2). ``--save``
writes the logits; ``--compare`` reads them and fails unless every
tensor is equal bit for bit, printing each case's verdict and the card;
``--match`` keeps only the cases whose name holds it (``--match fp32``:
K2's, when K2r is meant to differ).
Nothing here is imported by the port.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def cases(torch, src: str) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core import meshnet
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = meshnet.init(cfg, generator=gen, device=dev)
    for layer in params["layers"]:  # non-trivial biases and BatchNorm statistics
        c = layer["b"].shape[0]
        layer["b"] = (0.1 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_scale"] = (1.0 + 0.2 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_bias"] = (0.1 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_mean"] = (0.3 * torch.randn(c, generator=gen)).to(dev)
        layer["bn_var"] = (0.5 + torch.rand(c, generator=gen)).to(dev)
    x = torch.rand((1, 256, 256, 256), generator=gen).to(dev)
    out = {}
    for precision in ("fp32", "bf16", "int8w"):
        out[f"256^3 {precision}"] = ops.meshnet_apply_megakernel(params, x, cfg, precision=precision).cpu()
    small = torch.rand((2, 37, 45, 29), generator=gen).to(dev)
    pln = mk.plan_for_config(cfg, small.shape[1:], smem_budget=40_000, batch=2)
    out[f"fp32 forced plan of {len(pln.segments)} segments"] = ops.meshnet_apply_megakernel(params, small, cfg,
                                                                                            pln=pln).cpu()
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", required=True, help="the src/ directory whose repro_torch to run")
    mode = parser.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", help="write the outputs here")
    mode.add_argument("--compare", help="compare with the outputs written here")
    parser.add_argument("--match", default="", help="only the cases whose name holds this (e.g. fp32)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k2_bit_equal: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip()}; repro_torch from {args.src}")
    out = {key: t for key, t in cases(torch, args.src).items() if args.match in key}
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(out, args.save)
        print(f"saved {sorted(out)} to {args.save}")
        return 0
    saved = {key: t for key, t in torch.load(args.compare).items() if args.match in key}
    ok = sorted(saved) == sorted(out)
    for key, got in out.items():
        same = key in saved and saved[key].dtype == got.dtype and torch.equal(saved[key], got)
        diff = float((saved[key].float() - got.float()).abs().max()) if key in saved and not same else 0.0
        print(f"{key}: {'bit-equal' if same else f'DIFFERS (max abs diff {diff})'}")
        ok &= same
    print("k2_bit_equal: " + ("all bit-equal" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
