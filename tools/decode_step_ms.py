"""Time the LM decode path of one checkout of the port on the card.

Serves TinyLlama-1.1B at full width (fp32, random weights from a seed)
through ``LMEngine`` as ``chip_smoke.py`` phase 8c does (4 slots, a cache
of 1024, prompts of 32 to 256 tokens, 32 new tokens each), then times one
``decode_step`` at 4 slots and pos 255 on its own. Prints one JSON line:
the engine's wall seconds and tokens a second, and per decode step the
CUDA-event median (``step_ms``), the host's time to issue it (``issue_ms``,
no synchronisation) and its wall time with one (``wall_ms``), medians over
``--steps`` steps. Host times vary from call to call on a shared host, so
compare two checkouts within one run of the machine, alternating them:

    python3 tools/decode_step_ms.py --src build/parent/src   # the parent
    python3 tools/decode_step_ms.py --src src                # this tree
"""

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default="src", help="the src directory of the checkout to time")
    ap.add_argument("--requests", type=int, default=6, help="requests the engine serves")
    ap.add_argument("--steps", type=int, default=30, help="decode steps timed on their own")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serving.engine import LMEngine, Request

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("tinyllama-1.1b"), dtype=torch.float32)  # as launch/serve.py serves it
    params = model.init(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    lens = torch.randint(32, 257, (args.requests,), generator=gen).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (m,), generator=gen).tolist(), max_new_tokens=32, id=i)
            for i, m in enumerate(lens)]
    engine = LMEngine(params, cfg, slots=4, max_seq=1024, prefill_chunk=64, device=dev)
    engine.run(reqs[:1])  # builds the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    tokens = sum(len(c.tokens) for c in outs)

    token = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(dev)
    step = lambda: model.decode_step(params, token, engine.cache, 255, cfg)  # noqa: E731
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    events, issue, wall = [], [], []
    for _ in range(args.steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        events.append(start.elapsed_time(end))
        issue.append(1e3 * (t1 - t0))
        wall.append(1e3 * (t2 - t0))
    print(json.dumps(dict(
        src=args.src, requests=len(reqs), tokens=tokens, engine_wall_s=wall_s, tokens_per_s=tokens / wall_s,
        engine_steps=engine.steps, step_ms=statistics.median(events), issue_ms=statistics.median(issue),
        wall_ms=statistics.median(wall), steps=args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
