"""Serving launcher — counterpart of ``repro/launch/serve.py``: batched MRI
segmentation (the paper's deployment) or LM generation for a dense arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --engine segmentation -n 4
  PYTHONPATH=src python -m repro_torch.launch.serve --engine lm --arch tinyllama-1.1b -n 3
  PYTHONPATH=src python -m repro_torch.launch.serve --engine lm --device cpu

Both run the arch's or model's smoke-size weights, random from seed 0, on
the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device


def serve_segmentation(args):
    from repro_torch.core import meshnet
    from repro_torch.core.meshnet import MeshNetConfig
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.data import mri
    from repro_torch.serving.engine import SegmentationEngine
    from repro_torch.telemetry.budget import MemoryBudget

    dev = resolve_device(args.device)
    shape = (args.volume,) * 3
    cfg_m = MeshNetConfig()
    params = meshnet.init(cfg_m, generator=torch.Generator().manual_seed(0), device=dev)
    pc = PipelineConfig(model=cfg_m, volume_shape=shape, min_component_size=8)
    eng = SegmentationEngine(params, pc, budget=MemoryBudget.h100(), device=dev)
    gen = torch.Generator().manual_seed(1)
    for i in range(args.n):
        vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=shape), device=dev)
        res = eng.submit(vol)
        t = res.record.times
        print(
            f"req {i}: {res.record.status} mode={res.record.mode} "
            f"pre {t.preprocessing:.2f}s inf {t.inference:.2f}s post {t.postprocessing:.2f}s"
        )
    print(f"success rate: {eng.log.success_rate()*100:.1f}%")


def serve_lm(args):
    from repro_torch import configs
    from repro_torch.models import model as MD
    from repro_torch.serving.engine import LMEngine, Request

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(configs.get_smoke(args.arch), dtype=torch.float32)
    params = MD.init(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    eng = LMEngine(params, cfg, slots=args.slots, max_seq=args.max_seq, prefill_chunk=8, device=dev)
    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.n):
        plen = int(torch.randint(3, 12, (), generator=gen))
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=gen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=args.max_new, id=i))
    t0 = time.perf_counter()
    outs = eng.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(c.tokens) for c in outs)
    for c in outs:
        print(f"req {c.id}: {len(c.tokens)} tokens, prefill {c.prefill_s:.2f}s")
    print(f"{total} tokens in {dt:.2f}s = {total/dt:.1f} tok/s ({args.arch} reduced, {dev.type})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="segmentation", choices=["segmentation", "lm"])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("-n", type=int, default=4)
    ap.add_argument("--volume", type=int, default=48)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    if args.engine == "segmentation":
        serve_segmentation(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
