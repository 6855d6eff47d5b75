#!/usr/bin/env python3
"""Drive the PyTorch port's segmentation, training and LM-serving main
paths on one CUDA card, and segmentation's sub-volume mode and bf16 and
int8w policies (through K1r and K2r), its Z-sharded executors, its
queued serving through the request scheduler, the resilience layer and
artifact cache behind it, the replicated fleet of schedulers, and the
U-Net baseline.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # tiny shapes, plain paths, CPU

The port has two kernel-backed forwards: ``cuda_fused`` (K1, the fused
dilated conv, one launch per layer) and ``cuda_megakernel`` (K2, the
depth-first segment kernel, one launch per segment of a plan); and a
training path whose hard Dice metric and held-out scores go through K3
(the per-class Dice count kernel, one launch per score); and LM serving
(LMEngine at TinyLlama-1.1B's full width), whose every attention layer of
every decode step is one launch of K4 (decode attention). K5 (the
27-view conv) computes K1's function and checks it. At the bf16 and
int8w policies ``cuda_fused`` launches K1r (K1 at reduced widths) a
layer and ``cuda_megakernel`` K2r (K2 at reduced widths: bf16 or int8
staging) a segment. Phases, each printed on lines of its own:

1. device   the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel source of the port, all at once,
            timed, with ptxas' register and shared-memory report; K1, K2
            (the conv tile core) and K2r (the bf16 tensor-core kernel)
            spill no register at any width
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
            shapes (kernel, plain, F.conv3d with TF32 off, bound, the share
            of the bound, blocks, blocks an SM and waves, and K1 built
            without its copies and without its FFMAs: the split of its
            time); K2 per segment of
            the 256^3 plan (the same, and the planner's modeled ms; its
            blocks an SM held to the runtime's occupancy), the d = 4
            one-layer segment at tiles 16^3, 32^3, 64^3, 16x16x256 and
            4x4x256; the whole forwards under torch, cuda_fused and
            cuda_megakernel.
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
8. LM       8a  K4 against its plain version on the card: the reference's
                four kernel cases and its bf16 case, TinyLlama's served
                shape (B 4, H 32, KV 4, hd 64, S 1024) at pos 0, 1, 511,
                512, 1023 (fp32) and 255, 1023 (bf16), each with pos a
                host int and a (1,) int32 on the card (bit-equal); one CUDA
                graph of K4 at the served shape replayed at 5 positions
                written into its pos tensor (fp32 and bf16); one kernel a
                call under torch.profiler; two calls back to back on one
                workspace, its counters back at 0; a sliding-window ring
                cache past its window (K4 called with min(pos, S-1)), and
                that attention_decode against the CPU's; fp32 within 2e-5
                absolute, bf16 within 3e-2;
            8b  K5 against the plain version (5e-5 relative) and bit-equal
                to K1, d = 1..16, fused and not, 1->5 and 5->5 at
                (2, 31, 33, 17) and 21->21; K5's path, its role as K1's
                oracle: every layer of one gwm_light forward at 256^3
                bit-equal, counts set to 0 just before and read just after;
                K5's times beside K1's at phase 6's layer shapes;
            8c  the main path: LMEngine(slots 4, max_seq 1024, prefill
                chunk 64) at TinyLlama-1.1B full width, fp32, random
                weights made on the card, 6 requests of 32-256 random
                prompt tokens and 32 greedy tokens each; every launch count
                set to 0 just before and read just after: K4 exactly 22 a
                decode_step, the others never. Then the card's decode
                against the CPU's (full width, 2 layers, a 32-token prompt,
                16 greedy tokens: each step's logits within 1e-4 of the
                largest, the tokens equal); forward against decode_step at
                22 layers over 64 tokens within 1e-3; times: K4 at the
                served shape at pos 255 and 1023 (kernel with pos a host
                int and on the card, plain, SDPA with enable_gqa: device
                time per call with a cold L2; the bound), a decode step at
                4 slots, one step under torch.profiler (its kernels, K4
                exactly 22 of them, and the card's busy ms)
9. reduced and sub-volume (segmentation, gwm_light with brain_mask_fast):
            9a  K1r against its plain version on the card, bf16 and int8
                weights, Cout 5/10/18/21, Cin 1/5/64, d 1/3/16/40 at
                (2, 10, 12, 14), and three larger shapes: within one bf16
                step (2^-8) of the layer's largest magnitude;
            9b  both models under cuda_fused with meshnet.init's weights:
                at the reference's shape (1, 10, 12, 14) its gates, bf16
                within 1e-3 and int8w within 2e-2 of the plain forward at
                their policy and bf16 within 1e-2 of fp32; at 256^3 bf16
                within 1e-2 and int8w within 2e-2 of the plain forward,
                relative to the largest logit; the gaps to fp32 (K1r's and
                the plain forward's) and the argmax agreement printed;
            9c  main paths, every count set to 0 just before and read just
                after: submit in mode subvolume (cube 64, overlap 46) under
                cuda_fused, K1 exactly 9 x (1 + cubes of the crop), and
                under cuda_megakernel, K2 exactly the mask plan's segments
                + cubes x the cube plan's; each segmentation agreeing with
                executor torch's in the same mode on >= 99.99 % of voxels
                and with mode full on every voxel at least the overlap (the
                receptive-field radius) inside the volume, the whole
                volume's agreement printed; one bf16 and one int8w
                request under auto, K1r exactly 18 each and K1 never; the
                same two under cuda_megakernel, K2r exactly the mask plan's
                + the main plan's segments each (segments x forwards), K1,
                K1r and K2 never; F1: an engine whose budget forces
                pick_mode to subvolume serves a 256^3 volume (K1 9 x 64);
            9d  CUDA-event medians of K1r per layer at bf16 and int8w at
                256^3 (kernel, its device time of 10 calls back to back,
                plain, F.conv3d at bf16, the bound: bf16 tensor-core
                operations or 2-byte activations, and the fp32 CUDA-core
                time of its operations; its tile, shared memory,
                registers, spills and blocks an SM, held to the Python
                mirror, and the rows it stages) and summed over a forward;
                K2r per segment of the
                256^3 plan at bf16 and int8w (a call's CUDA-event time,
                as every kernel's, and beside it its device time, 10 calls
                back to back; plain,
                F.conv3d at bf16 over the same layers, the bound: the
                function's operations over the bf16 tensor-core peak or
                its bytes at the policy's widths, the planner's modeled
                ms, its tensor-core MACs, input rows and (row, tap row)
                pairs, blocks an SM held to the runtime's, registers), each
                plan's segments and int8 crossings; the whole forwards at
                fp32, bf16 and int8w under cuda_fused and cuda_megakernel
            9e  K2r against its plain version at 256^3, segment by segment
                on the same staging arrays with poisoned borders and
                position and row-pitch pads (NaN for bf16, -128 for int8),
                at bf16 and int8w, on the planner's plan (gwm_light and
                brain_mask_fast; its segments and int8 crossings printed:
                under int8w int8 at the reference plan's boundaries only,
                the segments after them dequantising), on a forced plan of
                multi-layer segments and, at int8w, on the plan with int8
                at every boundary (gwm_light): int8 codes within +-1
                and equal at >= 99.9 %, bf16 within one bf16 step at the
                array's largest magnitude; then each forward under
                cuda_megakernel against the plain version of its plan,
                bf16 within 1e-2 and int8w within 8e-2 of the largest
                logit (int8 staging: the reference's staged gate), the gaps
                to the plain reduced forward and to fp32 and the argmax
                agreements printed
10. shard   gwm_light at 256^3 on 4 Z-slabs ([cuda:0] * 4 on one card):
            10a K2z and K2r-z against their plain versions on the first
                and last windows, segment by segment on the bands the
                slab's kept rows need, rows outside the bounds and the rows
                no band writes junk, each within the gates of 9e; the kept
                rows bit-equal to the whole window's;
            10b main paths: sharded_cuda_megakernel@4 at fp32, bf16 and
                int8w (the single-device and window plans' segments and
                int8 crossings printed; bit-equal to the whole windows'
                forwards cropped) and sharded_cuda_fused@4, each held to its
                single-device forward; pipeline.run(shard_devices=4);
            10c K2z and K2r-z CUDA-event times per window segment on its
                band (device times beside them, plain, F.conv3d over the band's rows, the bound over the
                band and over the rows inside z_bounds), and the sharded
                forwards beside the single-device ones
11. queued  serving through the request scheduler (serving/scheduler.py),
            one SegmentationEngine at 256^3 with brain_mask_fast as the
            crop model, each line with the card's name and power limit:
            11a main path: submit_async of 2 interactive fp32 requests
                (auto), a bf16 and an int8w standard one, a batch fp32 one
                under cuda_megakernel and a garbage 1-D volume, then drain,
                under an admission budget that demotes the fp32 requests
                to mode subvolume and not the reduced ones; every count
                set to 0 just before the drain and read just after: K1,
                K1r and K2 exactly what the records imply; conserved,
                classes dispatched in priority order, every request but
                the garbage ok (a kernel that raises would be a typed
                failure here) and stamped with its executor, precision,
                class and batch size, queue_wait_s + service_s the
                request's end to end, each segmentation equal to submit's
                at the resolved mode, executor and precision (host ms of
                both printed); the garbage request a permanent_fault;
            11b submit_many of 3 volumes at None, bf16, int8w: submission
                order, each equal to submit's, one resolution a signature;
            11c simulate(reference_engine("cuda"), preset("steady",
                horizon_s=60)) with execute=True: conserved, every
                request but the garbage lane ok under cuda_fused
12. resilience and the artifact cache, phase 11's configuration, each
            line with the card's name and power limit:
            12a an ArtifactCache behind the scheduler: one volume queued 3
                times and one other, drained: exactly 2 executions, 2
                coalesced with cache_hit, launches exactly what the 2
                records imply, each segmentation equal to submit's and no
                two completions (nor the cache) sharing storage; the volume
                again: a hit at admission with 0 launches; a permanent
                fault injected on a third volume, negative-cached, its twin
                a negative hit with 0 launches; quarantined_served 0;
                content_hash ms of a 256^3 volume on the card; the cache's
                device bytes beside its modeled bytes
            12b a transient FaultPlan on cuda_megakernel for 1 s of the
                scheduler's clock (time.monotonic()), retries and a breaker
                (trip_after 2, cooldown 1.5 s), 6 requests under
                cuda_megakernel: the faults raise before any launch and are
                all injected ones; served in order, cuda_fused (K1) while
                the breaker is open, then a half-open probe and the rest
                under cuda_megakernel (K2); transitions open, half_open,
                closed; faulted == recovered, retries >= 2; launches
                exactly what the records imply; each segmentation agreeing
                with submit's under its executor on >= 99.99 %
            12c two submits of one raw volume under a ConformMemo: one hit,
                equal segmentations, the memo's volume unchanged; the
                preprocessing ms of the miss, the hit and a memo-less
                conform
13. fleet   the replicated fleet (serving/fleet.py): replicas in phase 11's
            configuration, each engine with its own copy of the weights,
            each line with the card's name and power limit:
            13a main path: a Fleet of 2 replicas under cache_affinity,
                executed; wave 1 an fp32 (auto) and a bf16 request, drained,
                wave 2 two fp32 (auto), a bf16 and an fp32 under
                cuda_megakernel, drained; every count set to 0 just before
                and read just after: K1, K1r and K2 exactly what the records
                imply; conserved, every ledger entry served once, cold
                compiles = distinct (replica, signature) pairs, wave 2's
                warm signatures routed to their warm replica (affinity
                hits), each segmentation equal to submit's on a standalone
                engine; each replica's first request of a signature (host
                ms) beside its later ones;
            13b failover: 4 fp32 requests round-robin, crash_replica(0) with
                2 queued there: each re-dispatched once, served on replica 1
                equal to submit's, launches exactly the 4 records'; then
                drain_replica(1) on a fresh fleet: no route to it, retired;
            13c simulate_fleet(fleet_preset("fleet_steady", horizon_s=60))
                executed on reference_engine replicas: conserved, every
                request but the garbage lane ok under a card executor, each
                fid's replica, dispatches and outcome equal to the same
                configuration's modeled run;
            13d FleetConfig(cache=CacheConfig()): a 256^3 volume served on
                replica 0, its byte-equal twin routed to replica 1 an
                admission hit with 0 launches, no storage shared
14. unet3d  the U-Net baseline (core/unet3d.py), base 8, 2 levels: at 64^3
            the card's logits within 1e-4 of the CPU forward's on the same
            weights (relative to the largest, TF32 off), argmax agreeing on
            >= 99.99 %; at 256^3 its CUDA-event forward time beside
            gwm_light's cuda_fused forward
15. kernels one JSON line describing every ported kernel (K1-K5, K1r, K2r,
            K2z)
16. ok      the last line, {"ok": true, "device": {...}}

Any failed check raises, so the script exits non-zero and prints no ok
line. Without a CUDA device (and without --cpu-rehearsal) it exits 1.
--cpu-rehearsal runs phases 1, 4, 5, 7b, 7c, 8c (TinyLlama's smoke
config), 9b, 9e, 9c (cube 8, overlap 4), 10a, 10b, 11, 12, 13 (13c over
10 virtual seconds) and 14 (at 16^3) at a tiny size on the CPU with the
plain versions, to find wrong paths and shapes without a card; it never
prints the ok line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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

from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch import synchronize, tree  # noqa: E402
from repro_torch.core import conform, executors, meshnet, pipeline, spatial_shard, unet3d  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.data import mri  # noqa: E402
from repro_torch.kernels import _build, ops, quantize, ref  # noqa: E402
from repro_torch.kernels import decode_attention as k4  # noqa: E402
from repro_torch.kernels import dice as k3  # noqa: E402
from repro_torch.kernels import dilated_conv3d as k1  # noqa: E402
from repro_torch.kernels import megakernel as k2  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.serving.engine import LMEngine, Request, SegmentationEngine  # noqa: E402
from repro_torch.serving import cache as cache_mod  # noqa: E402
from repro_torch.serving import simulator  # noqa: E402
from repro_torch.serving.cache import ArtifactCache, CacheConfig, ConformMemo  # noqa: E402
from repro_torch.serving.fleet import Fleet, FleetConfig, fleet_preset, simulate_fleet  # noqa: E402
from repro_torch.serving.resilience import BreakerConfig, FaultPlan, FaultRule, ResiliencePolicy, RetryPolicy  # noqa: E402
from repro_torch.serving.scheduler import RequestScheduler, SchedulerConfig  # noqa: E402
from repro_torch.telemetry.budget import MemoryBudget  # noqa: E402
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


def cold_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` with a cold L2, as the
    served path finds it: before each call a 256 MiB write evicts the
    50 MB L2, and a spin kernel keeps the card busy while the host enqueues
    the call, so the CUDA events around the call time its kernels and not
    the host's time between their launches (most of a call that does a few
    microseconds of work)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(4_000_000)  # about 2 ms at the H100's clock
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: CUDA events around ``runs``
    calls that run back to back on the card, enqueued by the host while a
    spin kernel holds the card, then divided by ``runs``. A short launch
    (K2r's, a window's K2z) takes less device time than its wrapper takes
    on the host, so events around calls that the card waits for would time
    the host. Fails unless the host enqueued every call before the spin
    ended (else it retries with a longer spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 40_000_000  # about 20 ms at the H100's clock
    for _ in range(4):
        before, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        before.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < before.elapsed_time(start):
            return start.elapsed_time(end) / runs
        spin *= 4
    check(False, f"the host did not enqueue {runs} calls within the card's spin ({host_ms:.1f} ms)")


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


def k2_work(pln, i: int, vol=None) -> tuple[int, int]:
    """(operations, bytes) segment i of ``pln`` must do and move, counted
    as K1's are: each layer's in-volume taps and epilogue over the true
    volume (``vol``, default the plan's), the fused head's products and
    bias; the segment's input read once, its parameters once, its output
    written once. The plan's halo recompute and haloed window reads are not
    part of the function: they price the schedule (``plan_bound_ms``)."""
    seg = pln.segments[i]
    vol = tuple(vol or pln.vol)
    shape, voxels = (1,) + vol, math.prod(vol)
    ops_, cin = 0, seg.cin
    for d in seg.dilations:
        ops_ += k1_work(shape, cin, seg.channels, d)[0]
        cin = seg.channels
    if seg.fuse_head:
        ops_ += 2 * voxels * seg.channels * seg.num_classes + voxels * seg.num_classes
    c, k = seg.channels, len(seg.dilations)  # weights, bias, scale, offset; the head's
    n_params = 27 * seg.cin * c + 27 * c * c * (k - 1) + 3 * c * k
    if seg.fuse_head:
        n_params += c * seg.num_classes + seg.num_classes
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
    for name in ("dilated_conv3d", "megakernel", "megakernel_lp"):  # the conv tile core at every width
        spills = [line for line in _build.build_log(name).splitlines() if "spill" in line]
        check(len(spills) >= 4 and all("0 bytes spill stores, 0 bytes spill loads" in line for line in spills),
              f"{name}.cu spills registers: {spills}")


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
        ((1, 40, 40, 300), 5, 5, 1, True),  # rows of two chunks
        ((1, 30, 30, 30), 64, 21, 3, True),  # one warp a block, a narrower box
        ((1, 24, 24, 100), 5, 10, 40, True),  # d past the box: three windows
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
        print(f"{model} megakernel plan: {[(s.dilations, s.tile) for s in pln.segments]}; blocks "
              f"{[pln.segment_blocks(i) for i in range(len(pln.segments))]}; modeled {pln.modeled_ms():.4f} ms; "
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


def served_models(dev, size: int):
    """The served configuration of phases 5 and 9c: gwm_light with
    brain_mask_fast as the crop model (random weights from SEED + 5, BN
    statistics too), three raw volumes (one non-cubic), and the engine."""
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
    return cfg, mcfg, params, mparams, vols, engine


def phase_serve(dev, size: int) -> dict:
    print(f"== phase 5: serve 3 requests at {size}^3 through SegmentationEngine.submit, once per kernel path")
    cfg, mcfg, _, _, vols, engine = served_models(dev, size)
    shape = (size,) * 3
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


def profile_step(run_step, unprofiled_ms: float, label: str = "train step") -> list:
    """Device time of one more step by kernel, from a torch.profiler
    trace, and the share of the step the card was busy. Returns the
    trace's device rows (empty when the profiler saw no device time)."""
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
        return []
    print(f"profile ({label}): device busy {busy_ms:.3f} ms of a profiled step of {wall * 1e3:.3f} ms "
          f"({busy_ms / (wall * 1e3):.1%}); {busy_ms / unprofiled_ms:.1%} of the unprofiled step's {unprofiled_ms:.3f} ms; "
          f"{sum(e.count for e in cuda)} device operations")
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile: {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    return cuda


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


def print_clocks() -> None:
    """The card's clock, power draw and limit, and temperature after a timing run."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"after timing: clocks.sm, power.draw, power.limit, temperature: {smi.stdout.strip()}")


def bound(ops_: float, bytes_: float, peak_flops: float, peak_bw: float) -> tuple[float, str]:
    t_ops, t_bytes = ops_ / peak_flops * 1e3, bytes_ / peak_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k1_ablation_ms(x, w, b, s, o, d) -> dict:
    """K1's time on these inputs built without its copies (FFMAs on
    whatever its ring holds) and without its FFMAs (copies and loop only):
    the split of a launch (csrc/conv_tile.cuh's two switches). Called on
    the C entry point, so these launches count nowhere."""
    B, D, H, W, cin = x.shape
    out = torch.empty((B, D, H, W, w.shape[-1]), device=x.device)
    times = {}
    for what, define in (("fma_only_ms", "CONV_TILE_NO_COPY"), ("copy_only_ms", "CONV_TILE_NO_FMA")):
        fn = _build.load("dilated_conv3d", (define,)).repro_dilated_conv3d_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), s.data_ptr(), o.data_ptr(), out.data_ptr(),
                B, D, H, W, cin, w.shape[-1], d, 1, torch.cuda.current_stream().cuda_stream)
        check(fn(*args) == 0, f"K1 ablation {define} launches")
        times[what] = time_ms(lambda: fn(*args))
    return times


def phase_times(dev, card: str, size: int) -> tuple[list[dict], list[dict]]:
    print(f"== phase 6: times at the main path's shapes ({size}^3, card: {card})")
    torch.backends.cudnn.benchmark = False
    _, peak_flops, peak_bw = peaks_for(card)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        ablations = k1_ablation_ms(x, w, b, s, o, d)
        plain_ms = time_ms(lambda: ref.dilated_conv3d(x, w, b, **kw))
        library_ms = time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, b, padding=d, dilation=d))
        ops_, bytes_ = k1_work(shape, cin, cout, d)
        bound_ms, bound_by = bound(ops_, bytes_, peak_flops, peak_bw)
        blocks, per_sm = k1.k1_occupancy(shape, cin, cout, d)
        row = dict(
            dilation=d, cin=cin, cout=cout, launches_per_forward=count,
            kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / kernel_ms,
            blocks=blocks, blocks_per_sm=per_sm, waves=blocks / (sms * per_sm), **ablations,
            ops=ops_, bytes=bytes_, library_rel_err=lib_rel,
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
        blocks, per_sm = pln.segment_blocks(i), k2.blocks_per_sm(seg)
        check(per_sm == int(k2._blocks_per_sm(k2._segment_smem_bytes(seg), seg.channels)),
              f"segment {i}: the planner's blocks an SM differ from the runtime's {per_sm}")
        row = dict(
            segment=i, dilations=list(seg.dilations), tile=list(seg.tile), fuse_head=seg.fuse_head,
            smem_bytes=int(k2._segment_smem_bytes(seg)), blocks=blocks, blocks_per_sm=per_sm,
            waves=blocks / (sms * per_sm), kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, share_of_bound=bound_ms / kernel_ms, modeled_ms=pln.segment_modeled_ms(i),
            ops=ops_, bytes=bytes_, plan_bound_ms=plan_bound_ms, plan_bound_by=plan_bound_by,
            multiply_adds=macs, modeled_bytes=modeled,
        )
        print("times " + json.dumps(row))
        seg_rows.append(row)

    print(f"times K2 plan: modeled {pln.modeled_ms():.4f} ms; kernels {sum(r['kernel_ms'] for r in seg_rows):.4f} ms; "
          f"bound {sum(r['bound_ms'] for r in seg_rows):.4f} ms")

    # The d = 4 layer alone at other tiles shows what the tile and the
    # block count cost: cubes of 16, 32, 64 and the plan's 256-wide rows.
    staging = torch.rand((1,) + (size + 8,) * 3 + (cfg.channels,), generator=gen).to(dev)
    for t in ((16,) * 3, (32,) * 3, (64,) * 3, (16, 16, 256), (4, 4, 256)):
        seg = k2.Segment(2, (4,), cfg.channels, cfg.channels, t)
        one = k2.MegakernelPlan((seg,), (size,) * 3)
        operands = ops.megakernel_operands(params, cfg, seg)
        ms = time_ms(lambda: k2.run_segment(staging, one, 0, *operands))
        print("times tile sweep " + json.dumps(dict(
            dilation=4, tile=list(t), blocks=one.segment_blocks(0), blocks_per_sm=k2.blocks_per_sm(seg),
            kernel_ms=ms, modeled_ms=one.segment_modeled_ms(0))))

    xs = x[..., 0]
    for name, fn in (("torch", meshnet.apply), ("cuda_fused", ops.meshnet_apply),
                     ("cuda_megakernel", ops.meshnet_apply_megakernel)):
        print(f"times forward {name}: {time_ms(lambda: fn(params, xs, cfg)):.4f} ms (one gwm_light forward at {size}^3)")
    print_clocks()
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
    print_clocks()
    return k3_row



# ----------------------------------------------------------- phase 8: LM ---

LM_ARCH = "tinyllama-1.1b"
LM_SLOTS, LM_MAX_SEQ, LM_CHUNK = 4, 1024, 64
LM_REQUESTS, LM_PROMPT, LM_NEW = 6, (32, 256), 32
K4_FP32_TOL = 2e-5  # tests/test_kernels.py:155, absolute
K4_BF16_TOL = 3e-2  # tests/test_kernels.py:166-169, absolute
LM_CPU_TOL = 1e-4  # card against CPU: a step's logits, relative to the largest
LM_DECODE_VS_FORWARD = 1e-3  # tests/test_models.py:84, relative to the largest logit
K4_TIMED_POS = 255  # K4's timed call: 256 valid slots, within the served positions


def k4_inputs(gen, B, H, KV, hd, S, dtype, device):
    return [torch.randn(shape, generator=gen).to(device, dtype)
            for shape in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def k4_work(B, H, KV, hd, n_valid, elem_bytes) -> tuple[int, int]:
    """(operations, bytes) of one decode attention: a multiply-add per
    (head, valid slot, d) for the scores and for PV, and the softmax's few
    operations per score; each valid K/V slot read once, q read and out
    written once."""
    return B * H * n_valid * (4 * hd + 5), elem_bytes * (2 * B * n_valid * KV * hd + 2 * B * H * hd)


def phase_parity_k4(dev) -> dict:
    print("== phase 8a: K4 parity against the plain version (card)")
    gen = torch.Generator().manual_seed(SEED + 81)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (B, H, KV, hd, S, pos, dtype): the reference's kernel cases, its bf16 case
        (2, 8, 2, 32, 100, 57, f32), (1, 4, 4, 16, 64, 63, f32), (3, 16, 8, 64, 200, 10, f32),
        (1, 8, 1, 32, 96, 95, f32), (2, 8, 4, 32, 80, 40, bf16),
    ]
    cases += [(4, 32, 4, 64, 1024, pos, f32) for pos in (0, 1, 511, 512, 1023)]  # TinyLlama, served
    cases += [(4, 32, 4, 64, 1024, pos, bf16) for pos in (K4_TIMED_POS, 1023)]
    worst = {f32: 0.0, bf16: 0.0}
    for B, H, KV, hd, S, pos, dtype in cases:
        q, k, v = k4_inputs(gen, B, H, KV, hd, S, dtype, dev)
        got = k4.decode_attention(q, k, v, pos)
        on_card = k4.decode_attention(q, k, v, torch.full((1,), pos, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        err = float((got.float() - ref.decode_attention(q, k, v, pos).float()).abs().max())
        tol = K4_FP32_TOL if dtype == f32 else K4_BF16_TOL
        same = bool(torch.equal(got, on_card))
        print(f"K4 B={B} H={H} KV={KV} hd={hd} S={S} pos={pos} {str(dtype)[6:]}: max_abs_err {err:.3e} (gate {tol}); "
              f"pos on the card gives the host int's result bit for bit: {same}")
        check(err <= tol, f"K4 abs err {err} > {tol} at B={B} H={H} KV={KV} hd={hd} S={S} pos={pos} {dtype}")
        check(same, f"K4 with pos on the card differs from the host int's at B={B} S={S} pos={pos} {dtype}")
        worst[dtype] = max(worst[dtype], err)

    # One CUDA graph of K4 at the served shape, replayed at positions
    # written into the same (1,) int32 tensor: each replay is the plain
    # version at that pos.
    for dtype in (f32, bf16):
        q, k, v = k4_inputs(gen, LM_SLOTS, 32, 4, 64, LM_MAX_SEQ, dtype, dev)
        pos_dev = torch.zeros((1,), dtype=torch.int32, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k4.decode_attention(q, k, v, pos_dev)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = k4.decode_attention(q, k, v, pos_dev)
        errs = []
        for pos in (0, K4_TIMED_POS, 700, LM_MAX_SEQ - 1, 1500):
            pos_dev.fill_(pos)
            graph.replay()
            torch.cuda.synchronize()
            errs.append(float((out.float() - ref.decode_attention(q, k, v, pos).float()).abs().max()))
        tol = K4_FP32_TOL if dtype == f32 else K4_BF16_TOL
        print(f"K4 CUDA graph ({str(dtype)[6:]}, served shape) replayed at pos 0, {K4_TIMED_POS}, 700, "
              f"{LM_MAX_SEQ - 1}, 1500: max_abs_err {max(errs):.3e} (gate {tol})")
        check(max(errs) <= tol, f"K4 graph replays {errs} over {tol}")
        worst[dtype] = max(worst[dtype], max(errs))
        del graph, out

    # One kernel a call, counted by torch.profiler in a process of its own
    # (in this one, after the profiled sessions of phases 5 and 7d, a session
    # around one call of some microseconds came back with no device event on
    # the card, where a fresh process's sessions show the kernel); and two
    # calls back to back that share the workspace.
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--k4-kernels"], capture_output=True,
                         text=True, timeout=600)
    check(run.returncode == 0, f"the K4 kernel count exited {run.returncode}: {run.stderr[-2000:]}")
    kernels = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"K4 kernels a call (torch.profiler, a fresh process): host pos {kernels['host']}, pos on the card "
          f"{kernels['on_card']}")
    check(all(len(n) == 1 and sum(n.values()) == 1 and "decode_attn" in next(iter(n)) for n in kernels.values()),
          f"K4 calls ran {kernels}, not one kernel each")
    q, k, v = k4_inputs(gen, LM_SLOTS, 32, 4, 64, LM_MAX_SEQ, f32, dev)
    spaces = len(k4._WORKSPACES)
    first = k4.decode_attention(q, k, v, LM_MAX_SEQ - 1)
    second = k4.decode_attention(q, k, v, torch.full((1,), 100, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    errs = [float((first - ref.decode_attention(q, k, v, LM_MAX_SEQ - 1)).abs().max()),
            float((second - ref.decode_attention(q, k, v, 100)).abs().max())]
    counts = k4._WORKSPACES[(q.device, LM_SLOTS, 4, k4.nsplit(LM_MAX_SEQ, LM_SLOTS * 4), 8, 64)][1]
    print(f"K4 back to back at pos {LM_MAX_SEQ - 1} and 100 on one workspace: max_abs_err {max(errs):.3e}; "
          f"workspaces {spaces} -> {len(k4._WORKSPACES)}; counters left at {int(counts.abs().sum())}")
    check(max(errs) <= K4_FP32_TOL and len(k4._WORKSPACES) == spaces and int(counts.abs().sum()) == 0,
          f"K4 back to back: {errs}, counters {counts.tolist()}")

    # A sliding-window ring cache (S = window = 1024) at pos 1500, past the
    # window: attention_decode writes slot 1500 % S and calls K4 with
    # min(pos, S - 1). Held against the plain version with that mask, and
    # the layer against the same layer on the CPU.
    cfg = lm_configs.get(LM_ARCH, dtype=f32, sliding_window=LM_MAX_SEQ)
    p = lm_layers.init_attention(gen, cfg, device="cpu")
    x = torch.randn((4, 1, cfg.d_model), generator=gen)
    ck, cv = (torch.randn((4, LM_MAX_SEQ, cfg.num_kv_heads, cfg.resolved_head_dim), generator=gen) for _ in "kv")
    pos = 1500
    expect, cpu_k, cpu_v = lm_layers.attention_decode(p, x, cfg, ck.clone(), cv.clone(), pos)
    card_k, card_v = ck.to(dev), cv.to(dev)
    before = k4.launches
    got, _, _ = lm_layers.attention_decode(tree.map(lambda t: t.to(dev), p), x.to(dev), cfg, card_k, card_v, pos)
    torch.cuda.synchronize()
    check(k4.launches == before + 1, "the sliding-window attention_decode launched K4 once")
    layer_rel = rel_err(got.cpu(), expect)[1]
    q = lm_layers._project_qkv(tree.map(lambda t: t.to(dev), p), x.to(dev), cfg,
                               torch.full((4, 1), pos, device=dev))[0]
    ring = min(pos, LM_MAX_SEQ - 1)
    err = float((k4.decode_attention(q, card_k, card_v, ring) - ref.decode_attention(q, card_k, card_v, ring)).abs().max())
    print(f"K4 sliding window S={LM_MAX_SEQ} pos={pos} -> min(pos, S-1)={ring}: max_abs_err {err:.3e}; "
          f"attention_decode card vs cpu rel {layer_rel:.3e}; ring slot written equal: "
          f"{bool(torch.equal(card_k[:, pos % LM_MAX_SEQ].cpu(), cpu_k[:, pos % LM_MAX_SEQ]))}")
    check(err <= K4_FP32_TOL, f"K4 sliding-window abs err {err} > {K4_FP32_TOL}")
    check(layer_rel <= LM_CPU_TOL, f"sliding-window attention_decode card vs cpu rel {layer_rel} > {LM_CPU_TOL}")
    worst[f32] = max(worst[f32], err)
    return {"fp32": worst[f32], "bf16": worst[bf16]}


def phase_views(dev, size: int, k1_rows) -> dict:
    print("== phase 8b: K5 (the 27-view conv) against the plain version and bit for bit against K1 (card)")
    gen = torch.Generator().manual_seed(SEED + 82)
    cases = [(s, cin, cout, d, affine)
             for s, cin, cout in (((2, 31, 33, 17), 1, 5), ((2, 31, 33, 17), 5, 5), ((1, 40, 36, 44), 21, 21))
             for d in (1, 2, 4, 8, 16) for affine in (False, True)]
    worst_abs = worst_rel = 0.0
    for shape, cin, cout, d, affine in cases:
        x, w, b, sc, o = conv_inputs(gen, shape, cin, cout, dev)
        kw = dict(dilation=d, scale=sc, offset=o, fuse_affine=affine)
        views = k1.dilated_conv3d(x, w, b, variant="views", **kw)
        halo = k1.dilated_conv3d(x, w, b, **kw)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(views, ref.dilated_conv3d(x, w, b, **kw))
        equal = bool(torch.equal(views, halo))
        print(f"K5 {shape} {cin}->{cout} d={d} affine={affine}: max_abs_err {abs_err:.3e} rel {rel:.3e}; bit-equal to K1: {equal}")
        check(rel <= KERNEL_REL_TOL, f"K5 rel err {rel} > {KERNEL_REL_TOL} at {shape} {cin}->{cout} d={d}")
        check(equal, f"K5 differs from K1 at {shape} {cin}->{cout} d={d} affine={affine}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel)

    # K5's path, its role in the reference: K1's oracle, here over one
    # served gwm_light forward at size^3, layer by layer. Counts 0 just
    # before, read just after.
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    act = conform.conform(vol, (size,) * 3)[None, ..., None]
    synchronize(dev)
    k1.launches = k1.views_launches = 0  # K5's path starts
    for i, d in enumerate(cfg.dilations):
        scale, offset = ops.fold_batchnorm(params["layers"][i])
        kw = dict(dilation=d, scale=scale, offset=offset, fuse_affine=True)
        w, b = params["layers"][i]["w"], params["layers"][i]["b"]
        nxt = k1.dilated_conv3d(act, w, b, **kw)
        check(bool(torch.equal(k1.dilated_conv3d(act, w, b, variant="views", **kw), nxt)),
              f"K5 differs from K1 at layer {i} of the served forward")
        act = nxt
    synchronize(dev)
    counts = {"K1": k1.launches, "K5": k1.views_launches}  # K5's path ends
    print(f"K5 as K1's oracle over one gwm_light forward at {size}^3: every layer bit-equal; launches {counts}")
    check(counts == {"K1": len(cfg.dilations), "K5": len(cfg.dilations)}, f"oracle path launched {counts}")
    del act, nxt, vol

    rows = []
    for row in k1_rows:  # K1's timed layers (phase 6): the same inputs' shapes for K5
        x, w, b, sc, o = conv_inputs(gen, (1, size, size, size), row["cin"], row["cout"], dev)
        kw = dict(dilation=row["dilation"], scale=sc, offset=o, fuse_affine=True)
        views_ms = time_ms(lambda: k1.dilated_conv3d(x, w, b, variant="views", **kw))
        halo_ms = time_ms(lambda: k1.dilated_conv3d(x, w, b, **kw))
        r = dict(dilation=row["dilation"], cin=row["cin"], cout=row["cout"], launches_per_forward=row["launches_per_forward"],
                 views_ms=views_ms, halo_ms=halo_ms, bound_ms=row["bound_ms"], bound_by=row["bound_by"])
        print("times K5 " + json.dumps(r))
        rows.append(r)
        del x
    return {"err": (worst_abs, worst_rel), "launches": counts["K5"], "rows": rows}


def k4_kernels_a_call() -> dict:
    """The kernels torch.profiler sees on the card during one K4 call at the
    served shape (after a warm-up call that builds the kernel and makes its
    workspace), pos a host int and a (1,) int32 on the card: {kernel name:
    count} of each."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    q, k, v = k4_inputs(torch.Generator().manual_seed(SEED + 82), LM_SLOTS, 32, 4, 64, LM_MAX_SEQ, torch.float32,
                        dev)
    pos_dev = torch.full((1,), K4_TIMED_POS, dtype=torch.int32, device=dev)
    k4.decode_attention(q, k, v, K4_TIMED_POS)
    out = {}
    for name, pos in (("host", K4_TIMED_POS), ("on_card", pos_dev)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            k4.decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
        out[name] = {e.key: e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    return out


def lm_requests(gen, cfg, n, prompt_range, new):
    lens = torch.randint(prompt_range[0], prompt_range[1] + 1, (n,), generator=gen).tolist()
    return [Request(prompt=torch.randint(0, cfg.vocab_size, (m,), generator=gen).tolist(), max_new_tokens=new, id=i)
            for i, m in enumerate(lens)]


def lm_cpu_agreement(dev, cfg, prompt_len: int, new: int) -> None:
    """The card's decode against the CPU's for one request, the pattern of
    phase 7b: the same params on both, a prompt of ``prompt_len`` tokens
    and ``new`` greedy tokens, as the engine serves it (the prompt's last
    token starts the greedy steps); every step's logits, and the tokens."""
    gen = torch.Generator().manual_seed(SEED + 83)
    params = lm_model.init(cfg, generator=gen, device="cpu")
    runs = [(params, "cpu"), (tree.map(lambda t: t.to(dev), params), dev)]
    caches = [lm_model.init_cache(cfg, 1, prompt_len + new, device=d) for _, d in runs]
    prompt = torch.randint(0, cfg.vocab_size, (prompt_len,), generator=gen).tolist()
    fed, worst, greedy = prompt[0], 0.0, []
    for pos in range(prompt_len - 1 + new):
        cpu, card = (lm_model.decode_step(p, torch.tensor([[fed]], device=d), c, pos, cfg)[0][0, -1].cpu()
                     for (p, d), c in zip(runs, caches))
        worst = max(worst, rel_err(card, cpu)[1])
        if pos + 1 < prompt_len:
            fed = prompt[pos + 1]
            continue
        fed = int(torch.argmax(cpu))
        check(fed == int(torch.argmax(card)), f"greedy token at position {pos + 1}: cpu {fed}, card {int(torch.argmax(card))}")
        greedy.append(fed)
    print(f"LM card vs cpu ({cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}): {prompt_len}-token prompt, "
          f"{len(greedy)} greedy tokens equal; worst step logits rel err {worst:.3e} (gate {LM_CPU_TOL})")
    check(worst <= LM_CPU_TOL, f"LM card vs cpu rel err {worst} > {LM_CPU_TOL}")


def profile_decode_step(params, cfg, cache, pos: int, tokens, unprofiled_ms: float) -> None:
    """One decode step under torch.profiler (``profile_step``), its device
    time split into K4, the matrix products and the rest."""
    cuda = profile_step(lambda: lm_model.decode_step(params, tokens, cache, pos, cfg), unprofiled_ms,
                        f"decode step, batch {tokens.shape[0]}, pos {pos}")
    if not cuda:
        return
    busy = sum(e.self_device_time_total for e in cuda) / 1e3
    k4_rows = [e for e in cuda if "decode_attn" in e.key]
    k4_ms = sum(e.self_device_time_total for e in k4_rows) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in cuda
                  if any(w in e.key.lower() for w in ("gemm", "gemv", "cutlass", "xmma", "matmul", "dot_kernel"))) / 1e3
    print("profile decode step " + json.dumps(dict(
        device_busy_ms=busy, kernels=sum(e.count for e in cuda), k4_kernels=sum(e.count for e in k4_rows),
        k4_ms=k4_ms, gemm_ms=gemm_ms, other_device_ms=busy - k4_ms - gemm_ms,
        unprofiled_step_ms=unprofiled_ms, host_share_of_unprofiled_step=1 - busy / unprofiled_ms)))
    check(sum(e.count for e in k4_rows) == cfg.num_layers, f"a decode step ran {[e.count for e in k4_rows]} K4 kernels")


def phase_lm(dev, card: str, rehearsal: bool) -> dict:
    cfg = lm_configs.get_smoke(LM_ARCH) if rehearsal else lm_configs.get(LM_ARCH)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)  # as launch/serve.py's serve_lm
    slots, max_seq, chunk = (4, 64, 8) if rehearsal else (LM_SLOTS, LM_MAX_SEQ, LM_CHUNK)
    prompt_range, new = ((4, 12), 4) if rehearsal else (LM_PROMPT, LM_NEW)
    print(f"== phase 8c: LMEngine, {cfg.name} at {'smoke' if rehearsal else 'full'} width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
          f"fp32, {LM_REQUESTS} requests, {slots} slots: main path of K4")
    t0 = time.perf_counter()
    gen_dev = torch.Generator(device=dev).manual_seed(SEED + 84)
    params = lm_model.init(cfg, generator=gen_dev, device=dev)
    synchronize(dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"params: {n_params} ({n_params * 4 / 2**30:.3f} GiB fp32) made on {dev.type} in {time.perf_counter() - t0:.2f} s")
    reqs = lm_requests(torch.Generator().manual_seed(SEED + 85), cfg, LM_REQUESTS, prompt_range, new)
    engine = LMEngine(params, cfg, slots=slots, max_seq=max_seq, prefill_chunk=chunk, device=dev)
    synchronize(dev)
    k1.launches = k1.views_launches = k2.launches = k3.launches = k4.launches = 0  # main path starts
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    synchronize(dev)
    wall = time.perf_counter() - t0
    counts = {"K1": k1.launches, "K2": k2.launches, "K3": k3.launches, "K4": k4.launches, "K5": k1.views_launches}
    # main path ends
    tokens = sum(len(c.tokens) for c in outs)
    for c, r in zip(outs, reqs):
        print(f"LM request {c.id}: prompt {len(r.prompt)} tokens, {len(c.tokens)} generated; prefill {c.prefill_s:.4f} s, "
              f"decode {c.decode_s:.4f} s")
        check(len(c.tokens) == new and all(0 <= t < cfg.vocab_size for t in c.tokens), f"request {c.id} tokens")
    check([c.id for c in outs] == list(range(LM_REQUESTS)), "every request completed")
    prefill_steps = sum(len(r.prompt) - 1 for r in reqs)
    print("LM serve " + json.dumps(dict(
        requests=LM_REQUESTS, generated_tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
        prefill_s_per_request=statistics.mean(c.prefill_s for c in outs), decode_steps=engine.steps,
        prefill_steps=prefill_steps, lockstep_steps=engine.steps - prefill_steps, launches=counts)))
    expected = ({"K1": 0, "K2": 0, "K3": 0, "K4": engine.steps * cfg.num_layers, "K5": 0}
                if dev.type == "cuda" else dict.fromkeys(counts, 0))
    check(counts == expected, f"LM path launched {counts}, expected {expected}")

    out = {"counts": counts}
    lm_cpu_agreement(dev, dataclasses.replace(cfg, num_layers=2), *((8, 4) if rehearsal else (32, 16)))

    # forward against decode_step at full depth: the reference's invariant
    T = 16 if rehearsal else 64
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=torch.Generator().manual_seed(SEED + 86)).to(dev)
    full, _ = lm_model.forward(params, {"tokens": toks}, cfg)
    cache = lm_model.init_cache(cfg, 1, T, device=dev)
    steps = torch.cat([lm_model.decode_step(params, toks[:, t : t + 1], cache, t, cfg)[0] for t in range(T)], 1)
    fwd_rel = rel_err(steps, full)[1]
    print(f"LM forward vs decode_step over a {T}-token prompt, {cfg.num_layers} layers: rel {fwd_rel:.3e} "
          f"(gate {LM_DECODE_VS_FORWARD})")
    check(bool(torch.isfinite(full).all()) and fwd_rel <= LM_DECODE_VS_FORWARD, f"forward vs decode rel {fwd_rel}")
    del full, steps, cache
    if rehearsal:
        return out

    # Times at the served shape: K4 per call (device time with a cold L2;
    # and the CUDA-event time of back-to-back calls, the host's time
    # included) at pos 255 and at the full cache, pos as a host int and on
    # the card, beside its plain version and SDPA; a decode step at 4 slots.
    _, peak_flops, peak_bw = peaks_for(card)
    gen = torch.Generator().manual_seed(SEED + 87)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = k4_inputs(gen, LM_SLOTS, H, KV, hd, LM_MAX_SEQ, torch.float32, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, hd) views
    at = {}
    for pos in (K4_TIMED_POS, LM_MAX_SEQ - 1):
        n_valid = pos + 1
        mask = (torch.arange(LM_MAX_SEQ, device=dev) < n_valid)[None, None, None, :]
        pos_dev = torch.full((1,), pos, dtype=torch.int32, device=dev)
        kernel = lambda: k4.decode_attention(q, k, v, pos)  # noqa: E731
        on_card = lambda: k4.decode_attention(q, k, v, pos_dev)  # noqa: E731
        plain = lambda: ref.decode_attention(q, k, v, pos)  # noqa: E731
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_err = float((library().transpose(1, 2) - plain()).abs().max())
        ops_, bytes_ = k4_work(LM_SLOTS, H, KV, hd, n_valid, 4)
        bound_ms, bound_by = bound(ops_, bytes_, peak_flops, peak_bw)
        at[pos] = dict(kernel_ms=cold_ms(kernel), kernel_pos_on_card_ms=cold_ms(on_card), plain_ms=cold_ms(plain),
                       library_ms=cold_ms(library), bound_ms=bound_ms, bound_by=bound_by, ops=ops_, bytes=bytes_,
                       library_abs_err=lib_err,
                       call_ms_cuda_events={name: time_ms(fn) for name, fn in (
                           ("kernel", kernel), ("kernel_pos_on_card", on_card), ("plain", plain),
                           ("library", library))})
    k4_row = dict(B=LM_SLOTS, H=H, KV=KV, hd=hd, S=LM_MAX_SEQ, pos=K4_TIMED_POS,
                  chunks=k4.nsplit(LM_MAX_SEQ, LM_SLOTS * KV), blocks=k4.nsplit(LM_MAX_SEQ, LM_SLOTS * KV) * KV * LM_SLOTS,
                  **at[K4_TIMED_POS], full_cache={"pos": LM_MAX_SEQ - 1, **at[LM_MAX_SEQ - 1]})
    print("times K4 " + json.dumps(k4_row))

    tokens4 = torch.randint(0, cfg.vocab_size, (LM_SLOTS, 1), generator=gen).to(dev)
    pos = K4_TIMED_POS
    step_ms = time_ms(lambda: lm_model.decode_step(params, tokens4, engine.cache, pos, cfg), runs=20)
    weight_bytes = n_params * 4
    print("times decode step " + json.dumps(dict(
        batch=LM_SLOTS, pos=pos, step_ms=step_ms, weight_bytes=weight_bytes,
        weight_read_bound_ms=weight_bytes / peak_bw * 1e3, k4_launches_per_step=cfg.num_layers)))
    profile_decode_step(params, cfg, engine.cache, pos, tokens4, step_ms)
    print_clocks()
    out["k4_row"] = k4_row
    return out


# ------------------------------------- phase 9: sub-volume, bf16, int8w ---

K1R_STEP = 2.0**-8  # one bf16 step at the layer's largest magnitude
BF16_GATE = 1e-2  # bf16 logits against fp32 (tests/test_precision.py:60-70)
BF16_BACKENDS_GATE = 1e-3  # bf16 logits across backends (tests/test_precision.py:85)
INT8W_GATE = 2e-2  # int8w logits across backends (tests/test_precision.py:112)
ODD_SHAPE = (1, 10, 12, 14)  # the reference's precision tests' shape (tests/test_precision.py:44)
CUBE, OVERLAP = 64, 46  # the pipeline's defaults: overlap = MeshNet's receptive-field radius
BF16_TC_PEAK = 989e12  # dense bf16 on the H100 SXM's tensor cores (NVIDIA data sheet)


def reduced_inputs(gen, shape, cin, cout, w_int8: bool, device):
    """A reduced-precision layer's operands: a post-ReLU bf16 input, bf16
    weights or their int8 codes (the dequant scale folded into scale),
    fp32 bias, scale and offset."""
    x, w, b, s, o = conv_inputs(gen, shape, cin, cout, "cpu")
    x = torch.relu(x).to(torch.bfloat16)
    if w_int8:
        w, wscale = quantize.quantize_symmetric(w)
        s = s * wscale
    else:
        w = w.to(torch.bfloat16)
    return [t.to(device) for t in (x, w, b, s, o)]


def k1r_work(shape, cin, cout, dilation, weight_bytes) -> tuple[int, int]:
    """(operations, bytes) of one K1r layer: K1's operations; activations
    read and written at 2 bytes an element, the weights at their width,
    bias, scale and offset at 4."""
    ops_, _ = k1_work(shape, cin, cout, dilation)
    voxels = math.prod(shape)
    return ops_, 2 * voxels * (cin + cout) + 27 * cin * cout * weight_bytes + 12 * cout


def phase_reduced_parity(dev) -> float:
    print("== phase 9a: K1r (bf16 activations, bf16 or int8 weights) against its plain version (card)")
    gen = torch.Generator().manual_seed(SEED + 90)
    worst = 0.0
    for cout, cin, d, w_int8 in itertools.product((5, 10, 18, 21), (1, 5, 64), (1, 3, 16, 40), (False, True)):
        x, w, b, s, o = reduced_inputs(gen, (2, 10, 12, 14), cin, cout, w_int8, dev)
        kw = dict(dilation=d, scale=s, offset=o, fuse_affine=True)
        got = k1.dilated_conv3d(x, w, b, **kw)
        torch.cuda.synchronize()
        expect = ref.dilated_conv3d(x, w, b, **kw)
        err = float((got.float() - expect.float()).abs().max())
        limit = K1R_STEP * float(expect.float().abs().max())
        check(got.dtype == torch.bfloat16, "K1r writes bf16")
        check(err <= limit, f"K1r {cin}->{cout} d={d} int8={w_int8}: max_abs_err {err} > {limit}")
        worst = max(worst, err)
    print(f"K1r: 96 cases (Cout 5/10/18/21, Cin 1/5/64, d 1/3/16/40, bf16 and int8 weights) at (2, 10, 12, 14): "
          f"worst max_abs_err {worst:.4e}, each within one bf16 step (2^-8) of the layer's largest magnitude")
    for shape, cin, cout, d in (((1, 37, 45, 300), 5, 5, 2), ((1, 64, 64, 64), 5, 5, 16), ((1, 30, 30, 30), 64, 21, 3)):
        for w_int8 in (False, True):
            x, w, b, s, o = reduced_inputs(gen, shape, cin, cout, w_int8, dev)
            kw = dict(dilation=d, scale=s, offset=o, fuse_affine=True)
            got = k1.dilated_conv3d(x, w, b, **kw)
            torch.cuda.synchronize()
            expect = ref.dilated_conv3d(x, w, b, **kw)
            err = float((got.float() - expect.float()).abs().max())
            check(err <= K1R_STEP * float(expect.float().abs().max()), f"K1r {shape} {cin}->{cout} d={d}: {err}")
            print(f"K1r {shape} {cin}->{cout} d={d} int8={w_int8}: max_abs_err {err:.4e}")
            worst = max(worst, err)
    return worst


def logit_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b| in fp32, share of voxels whose argmax agrees)."""
    return float((a.float() - b.float()).abs().max()), float((a.float().argmax(-1) == b.float().argmax(-1)).float().mean())


def phase_reduced_forward(dev, size: int) -> None:
    print(f"== phase 9b: the served models' forwards at bf16 and int8w, cuda_fused against the plain path, "
          f"at the reference's shape {ODD_SHAPE} and at {size}^3")
    gen = torch.Generator().manual_seed(SEED + 91)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    x = conform.conform(vol, (size,) * 3)[None]
    odd = mri.generate(gen, mri.SyntheticMRIConfig(shape=ODD_SHAPE[1:]), device=dev)[0][None]
    for name in ("gwm_light", "brain_mask_fast"):
        cfg = meshnet.PAPER_MODELS[name]
        # meshnet.init's weights and BatchNorm, as the reference's precision tests
        params = meshnet.init(cfg, generator=gen, device=dev)
        # the reference's gates where it states them (tests/test_precision.py:
        # bf16 within 1e-2 of fp32; backends within 1e-3 at bf16 and 2e-2
        # at int8w of the plain forward), absolute
        o32 = executors.apply("cuda_fused", params, odd, cfg)
        for precision, gate in (("bf16", BF16_BACKENDS_GATE), ("int8w", INT8W_GATE)):
            got = executors.apply("cuda_fused", params, odd, cfg, precision=precision)
            plain = executors.apply("torch", params, odd, cfg, precision=precision)
            err, _ = logit_gap(got, plain)
            err32, _ = logit_gap(got, o32)
            print(f"{name} {precision} at {ODD_SHAPE}: cuda_fused vs plain max_abs {err:.4e}; vs fp32 max_abs {err32:.4e}")
            check(err <= gate, f"{name} {precision} at {ODD_SHAPE}: cuda_fused vs plain {err} > {gate}")
            if precision == "bf16":
                check(err32 <= BF16_GATE, f"{name} bf16 at {ODD_SHAPE}: vs fp32 {err32} > {BF16_GATE}")
        # at size^3: K1r's forward against the plain forward at its policy,
        # relative to the largest logit (bf16 steps grow with the logits;
        # both round fp32 sums taken in their own order at every layer)
        fp32 = executors.apply("cuda_fused", params, x, cfg)
        for precision, gate in (("bf16", BF16_GATE), ("int8w", INT8W_GATE)):
            got = executors.apply("cuda_fused", params, x, cfg, precision=precision)
            check(got.dtype == torch.bfloat16 and tuple(got.shape) == (1,) + (size,) * 3 + (cfg.num_classes,),
                  f"{name} {precision} logits {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got.float()).all()), f"{name} {precision} logits are finite")
            plain = executors.apply("torch", params, x, cfg, precision=precision)
            err, agree = logit_gap(got, plain)
            err32, agree32 = logit_gap(got, fp32)
            plain32, plain_agree32 = logit_gap(plain, fp32)
            top = float(plain.float().abs().max())
            print(f"{name} {precision} at {size}^3: cuda_fused vs plain {precision} max_abs {err:.4e} "
                  f"(largest logit {top:.4f}, argmax agrees {agree:.6%}); vs fp32 max_abs {err32:.4e} "
                  f"(argmax agrees {agree32:.6%}); the plain {precision} forward vs fp32 max_abs {plain32:.4e} "
                  f"(argmax agrees {plain_agree32:.6%})")
            check(err <= gate * top, f"{name} {precision} at {size}^3: cuda_fused vs plain {err} > {gate} x {top}")
            del got, plain
        del fp32


STAGED_INT8W_GATE = 8e-2  # int8w logits where int8 staging runs (tests/test_precision.py:114-135)


def bf16_step(top: float) -> float:
    """The spacing of bf16 values at magnitude ``top``: one step there."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def lp_gap(got: torch.Tensor, expect: torch.Tensor) -> tuple[bool, str, float]:
    """(within the gate, what, max abs diff) of K2r's staging array against
    its plain version's: int8 codes within +-1 and equal at >= 99.9 % of
    voxels; bf16 within one bf16 step at the array's largest magnitude."""
    diff = (got.float() - expect.float()).abs()
    worst, equal = float(diff.max()), float((diff == 0).float().mean())
    top = float(expect.float().abs().max())
    what = f"max_abs_diff {worst:.4e} equal {equal:.6%} largest {top:.4f}"
    if got.dtype == torch.int8:
        return worst <= 1 and equal >= 0.999, what, worst
    return worst <= bf16_step(top), what, worst


def poisoned(t: torch.Tensor, region: tuple) -> torch.Tensor:
    """A copy of staging array ``t`` whose border (all but ``region``) is
    poison no code writes: NaN for fp32 and bf16, -128 for int8 (codes
    stop at -127). A bf16 or int8 copy has K2r's layout
    (``megakernel.staging_empty``) with the pads of its positions and x-row
    pitches poisoned too."""
    poison = -128 if t.dtype == torch.int8 else float("nan")
    if t.dtype == torch.float32:
        out = torch.full_like(t, poison)
    else:
        out = k2.staging_empty(tuple(t.shape), t.dtype, t.device)
        out.as_strided((t.shape[0] * out.stride(0),), (1,)).fill_(poison)
    out[region] = t[region]
    return out


def k2r_stagings(pln, params, cfg, x: torch.Tensor, precision: str, scales):
    """Yield (i, input staging, operands) for every segment of the reduced
    plan ``pln``: the first staging the policy's input (int8 codes under
    int8w, else bf16), each later one K2r's output of the segment before;
    every border poisoned. ``params`` prepared for ``precision``."""
    first = pln.segments[0]
    h = first.halo
    x = quantize.quantize_input(x) if precision == "int8w" else x.to(torch.bfloat16)
    region = (slice(None),) + tuple(slice(h, h + v) for v in pln.vol) + (slice(None),)
    act = torch.zeros((x.shape[0],) + tuple(p + 2 * h for p in pln.padded(first)) + (x.shape[-1],), dtype=x.dtype,
                      device=x.device)
    act[region] = x
    act = poisoned(act, region)
    for i, seg in enumerate(pln.segments):
        layers, head = ops.megakernel_operands(params, cfg, seg, precision)
        deq, qs = k2.scale_operands(pln, i)
        operands = (layers, head, scales[seg.start - 1] if deq else None,
                    scales[seg.start + len(seg.dilations) - 1] if qs else None)
        yield i, act, operands
        if i + 1 < len(pln.segments):
            act = poisoned(k2.run_segment(act, pln, i, *operands), written(pln, i))


def plan_text(pln) -> str:
    """A plan's segments (first layer and tile of each) and int8 crossings."""
    int8_at = [seg.start for i, seg in enumerate(pln.segments) if i and pln.dtypes(i)[0] == torch.int8]
    return (f"{len(pln.segments)} segments at layers {[seg.start for seg in pln.segments]}, tiles "
            f"{[list(seg.tile) for seg in pln.segments]}, {pln.crossings} int8 crossings (at layers {int8_at})")


@contextlib.contextmanager
def plain_segments():
    """Within the block, every segment ops.meshnet_apply_megakernel runs
    takes K2's (K2r's) plain version: the plain forward of the same plan,
    staging included. Its launches count nowhere."""
    saved = k2.run_segment
    k2.run_segment = lambda x, pln, i, *operands: ref.megakernel_segment(x, pln, i, *operands)
    try:
        yield
    finally:
        k2.run_segment = saved


def forced_k2r_plan(cfg, vol: tuple, widths) -> "k2.MegakernelPlan":
    """gwm_light's schedule cut into multi-layer segments (which the
    time-priced planner does not choose: it prices the halo recompute),
    each at the largest of a few tiles whose layout at ``widths`` (K2r's,
    or K2's at fp32) fits one block."""
    tiles = ((8, 8, 64), (4, 4, 64), (4, 4, 32), (2, 2, 32), (2, 2, 8))
    cuts = ((0, 2), (2, 3), (3, 4), (4, 5), (5, 7), (7, 9))
    n = len(cfg.dilations)
    segments = []
    for i, j in cuts:
        for t in tiles:
            seg = k2.Segment(i, cfg.dilations[i:j], cfg.in_channels if i == 0 else cfg.channels, cfg.channels,
                             tuple(min(a, v) for a, v in zip(t, vol)), j == n, cfg.num_classes)
            if k2._segment_smem_bytes(seg, widths) <= k2.SMEM_BUDGET:
                segments.append(seg)
                break
        else:
            raise RuntimeError(f"no tile fits layers {i}..{j}")
    return k2.MegakernelPlan(tuple(segments), tuple(vol), widths)


def phase_reduced_megakernel(dev, size: int) -> float:
    print(f"== phase 9e: K2r (the megakernel at bf16 and int8w) against its plain version at {size}^3, segment by "
          "segment with poisoned borders; the forwards under cuda_megakernel")
    gen = torch.Generator().manual_seed(SEED + 95)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    x = conform.conform(vol, (size,) * 3)[None]
    worst = 0.0
    for name in ("gwm_light", "brain_mask_fast"):
        cfg = meshnet.PAPER_MODELS[name]
        params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
        fp32 = executors.apply("torch", params, x, cfg)
        for precision in ("bf16", "int8w"):
            prepared = quantize.prepare_params(params, cfg, precision)
            scales = quantize.staging_scales_from_bn(prepared, cfg) if precision == "int8w" else None
            pln = k2.plan_for_config(cfg, (size,) * 3, precision=precision)
            plans = [("planner's", pln)]
            if name == "gwm_light":
                plans.append(("forced", forced_k2r_plan(cfg, (size,) * 3, pln.widths)))
                if precision == "int8w":  # every later segment dequantises its int8 input (hi and lo weights)
                    plans.append(("int8 at every boundary", dataclasses.replace(pln, int8_at=None)))
            for which, p in plans:
                print(f"K2r {name} {precision} {which} plan at {size}^3: {plan_text(p)}")
                for i, act, operands in k2r_stagings(p, prepared, cfg, x[..., None], precision, scales):
                    seg = p.segments[i]
                    out = k2.run_segment(act, p, i, *operands)
                    synchronize(dev)
                    got = out[written(p, i)]
                    expect = ref.megakernel_segment(act, p, i, *operands)[written(p, i)]
                    ok, what, diff = lp_gap(got, expect)
                    if got.dtype == torch.bfloat16:
                        check(bool(torch.isfinite(got.float()).all()), f"K2r output finite at {name} segment {i}")
                    print(f"K2r {name} {precision} {which} plan segment {i}/{len(p.segments)} dilations {seg.dilations} "
                          f"tile {seg.tile} {act.dtype}->{got.dtype}: {what}")
                    check(ok, f"K2r {name} {precision} {which} segment {i}: {what}")
                    if got.dtype == torch.bfloat16:
                        worst = max(worst, diff)
                    del out, got, expect
            # the forward under cuda_megakernel at the policy, K2r once a
            # segment, against the plain version of the same plan
            got = executors.apply("cuda_megakernel", params, x, cfg, precision=precision)
            check(got.dtype == torch.bfloat16 and tuple(got.shape) == (1,) + (size,) * 3 + (cfg.num_classes,),
                  f"{name} {precision} cuda_megakernel logits {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got.float()).all()), f"{name} {precision} cuda_megakernel logits are finite")
            with plain_segments():
                plain = executors.apply("cuda_megakernel", params, x, cfg, precision=precision)
            reduced = executors.apply("torch", params, x, cfg, precision=precision)
            gate = BF16_GATE if precision == "bf16" else STAGED_INT8W_GATE
            err, agree = logit_gap(got, plain)
            top = float(plain.float().abs().max())
            err_r, agree_r = logit_gap(got, reduced)
            err32, agree32 = logit_gap(got, fp32)
            print(f"{name} {precision} cuda_megakernel at {size}^3: vs the plan's plain version max_abs {err:.4e} "
                  f"(largest logit {top:.4f}, argmax agrees {agree:.6%}); vs the plain {precision} forward "
                  f"(no staging) max_abs {err_r:.4e} (argmax {agree_r:.6%}); vs fp32 max_abs {err32:.4e} "
                  f"(argmax {agree32:.6%})")
            check(err <= gate * top, f"{name} {precision} cuda_megakernel vs plain: {err} > {gate} x {top}")
            del got, plain, reduced
        del fp32
    return worst


def k2r_work(pln, i: int, vol=None) -> tuple[int, int]:
    """(operations, bytes) of K2r's segment i, counted as K2's (``k2_work``)
    with each role at the plan's widths: the input staging at its width,
    the conv weights at theirs, the head's bf16, bias, scale, offset and the
    scales fp32, the output at its width."""
    seg = pln.segments[i]
    ops_, _ = k2_work(pln, i, vol)
    act, wt, _, _ = pln.widths
    ib, ob = (torch.tensor([], dtype=t).element_size() for t in pln.dtypes(i))
    voxels, c, k = math.prod(vol or pln.vol), seg.channels, len(seg.dilations)
    weights = (27 * seg.cin * c + 27 * c * c * (k - 1)) * wt
    vectors = 3 * c * k + seg.cin + c
    if seg.fuse_head:
        weights += c * seg.num_classes * act
        vectors += seg.num_classes
    return ops_, voxels * seg.cin * ib + weights + 4 * vectors + voxels * seg.cout * ob


def k2z_work(work, pln, i: int, z_bounds, band=None) -> tuple[int, int]:
    """(operations, bytes) of K2z's (K2r-z's) segment i on a window with
    valid rows ``z_bounds``: ``work`` (``k2_work`` or ``k2r_work``) over
    the rows inside ``ref.z_interval`` only, or, with ``band``, over the
    band's rows only (``megakernel.band_rows``: the rows the slab's kept
    rows need from this segment). Rows outside hold zeros or values no
    output of the sharded forward reads, so their outputs and the taps into
    them are not part of the function."""
    lo, hi = ref.z_interval(pln.vol[0], z_bounds) if band is None else k2.band_rows(pln, i, band)
    return work(pln, i, (hi - lo,) + tuple(pln.vol[1:]))


def count_launches(dev, fn):
    """(result, {K1, K1r, K2, K2r, K2z} launches) of ``fn()``: every count
    set to 0 just before and read just after (a main path). K2z counts
    K2's and K2r's launches with z_bounds."""
    synchronize(dev)
    k1.launches = k1.reduced_launches = k2.launches = k2.reduced_launches = k2.z_launches = 0
    res = fn()
    synchronize(dev)
    return res, {"K1": k1.launches, "K1r": k1.reduced_launches, "K2": k2.launches, "K2r": k2.reduced_launches,
                 "K2z": k2.z_launches}


def stages(rec) -> str:
    st = rec.times
    return (f"preprocessing {st.preprocessing:.4f} cropping {st.cropping:.4f} inference {st.inference:.4f} "
            f"postprocessing {st.postprocessing:.4f} total {st.total():.4f} s")


def phase_subvolume(dev, size: int, rehearsal: bool) -> dict:
    cube, overlap = (8, 4) if rehearsal else (CUBE, OVERLAP)
    print(f"== phase 9c: SegmentationEngine.submit in mode subvolume (cube {cube}, overlap {overlap}) at {size}^3, "
          "then bf16 and int8w requests, then the F1 probe")
    cfg, mcfg, params, mparams, vols, _ = served_models(dev, size)
    shape = (size,) * 3
    engine = SegmentationEngine(
        params, PipelineConfig(name="gwm_light", model=cfg, volume_shape=shape, use_cropping=True, cube=cube, overlap=overlap),
        mask_model=(mparams, mcfg), device=dev,
    )
    cuda = dev.type == "cuda"
    vol = vols[0]
    full = engine.submit(vol, mode="full")
    plain = engine.submit(vol, mode="subvolume", executor="torch")
    check(full.record.status == "ok" and plain.record.status == "ok", "full-mode and plain sub-volume requests")
    out = {}
    for executor in (None, "cuda_megakernel"):
        if not cuda and executor is not None:
            continue
        res, counts = count_launches(dev, lambda: engine.submit(vol, mode="subvolume", executor=executor))
        rec = res.record
        ncubes = math.prod(-(-s // cube) for s in rec.crop_size)
        name = rec.executor
        print(f"subvolume {name}: status {rec.status} crop {rec.crop_size} cubes {ncubes} launches {counts}; "
              f"modeled bytes {rec.hbm_bytes_modeled}; stages {stages(rec)}")
        check(rec.status == "ok" and rec.mode == "subvolume", f"subvolume request under {name}: {rec.status} {rec.fail_type}")
        if name == "cuda_fused":
            expect = {"K1": 9 * (1 + ncubes), "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}
        elif name == "cuda_megakernel":
            read = (cube + 2 * overlap,) * 3
            segs = len(k2.plan_for_config(cfg, read).segments)
            expect = {"K1": 0, "K1r": 0, "K2": len(k2.plan_for_config(mcfg, shape).segments) + ncubes * segs, "K2r": 0,
                      "K2z": 0}
        else:
            expect = {"K1": 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}
        check(counts == expect, f"subvolume {name} launches {counts}, expected {expect}")
        differ = res.segmentation != plain.segmentation
        agree = 1.0 - float(differ.float().mean())
        print(f"subvolume {name} vs subvolume torch: {int(differ.sum())} voxels differ ({agree:.6%} agree)")
        check(agree >= ARGMAX_AGREE, f"subvolume {name} agreement with the plain path {agree} < {ARGMAX_AGREE}")
        # Against mode full: a cube zero-pads only at its own faces, where
        # the full forward zero-pads at every layer, so within the receptive
        # field of the volume's faces the two may part (the reference's
        # patching.py says so); farther in, the trimmed merge is exact.
        differ = res.segmentation != full.segmentation
        agree = 1.0 - float(differ.float().mean())
        r = min(overlap, size // 2 - 1)
        inner = 1.0 - float(differ[r:-r, r:-r, r:-r].float().mean())
        print(f"subvolume {name} vs mode full: {int(differ.sum())} voxels differ ({agree:.6%} agree); "
              f"{inner:.6%} agree at least {r} voxels from the volume's faces")
        if overlap >= sum(cfg.dilations):  # the receptive-field radius
            check(inner == 1.0, f"subvolume {name} differs from mode full {r} or more voxels inside the volume")
        out[name] = counts
    for precision in ("bf16", "int8w"):
        res, counts = count_launches(dev, lambda: engine.submit(vol, precision=precision))
        rec = res.record
        print(f"{precision} request (auto): status {rec.status} mode {rec.mode} executor {rec.executor} "
              f"launches {counts}; params bytes {rec.params_bytes}; modeled bytes {rec.hbm_bytes_modeled}; "
              f"stages {stages(rec)}")
        check(rec.status == "ok" and rec.precision == precision, f"{precision} request: {rec.status} {rec.fail_type}")
        expect = {"K1": 0, "K1r": 2 * len(cfg.dilations) if cuda else 0, "K2": 0, "K2r": 0, "K2z": 0}
        check(counts == expect, f"{precision} request launches {counts}, expected {expect}")
        agree = 1.0 - float((res.segmentation != full.segmentation).float().mean())
        print(f"{precision} request vs the fp32 request: {agree:.6%} of voxels agree")
        out[precision] = counts
    out["reduced"] = {"K1r": out["bf16"]["K1r"] + out["int8w"]["K1r"]}
    # The same requests under cuda_megakernel: K2r once a segment of the
    # mask plan and of the main plan, both at the policy's widths (a main
    # path each: counts 0 just before, read just after).
    k2r = 0
    for precision in ("bf16", "int8w"):
        res, counts = count_launches(dev, lambda: engine.submit(vol, precision=precision, executor="cuda_megakernel"))
        rec = res.record
        print(f"{precision} request (cuda_megakernel): status {rec.status} mode {rec.mode} executor {rec.executor} "
              f"launches {counts}; modeled bytes {rec.hbm_bytes_modeled}; stages {stages(rec)}")
        check(rec.status == "ok" and (rec.executor, rec.precision) == ("cuda_megakernel", precision),
              f"{precision} cuda_megakernel request: {rec.status} {rec.fail_type} {rec.executor}")
        segs = (len(k2.plan_for_config(mcfg, shape, precision=precision).segments)
                + len(k2.plan_for_config(cfg, rec.crop_size, precision=precision).segments))
        expect = {"K1": 0, "K1r": 0, "K2": 0, "K2r": segs if cuda else 0, "K2z": 0}
        check(counts == expect, f"{precision} cuda_megakernel request launches {counts}, expected {expect} "
                                f"(segments x forwards)")
        plain = engine.submit(vol, precision=precision, executor="torch")
        for other, what in ((plain, f"the plain {precision} request"), (full, "the fp32 request")):
            agree = 1.0 - float((res.segmentation != other.segmentation).float().mean())
            print(f"{precision} cuda_megakernel request vs {what}: {agree:.6%} of voxels agree")
        k2r += counts["K2r"]
    out["reduced"]["K2r"] = k2r
    # F1: a budget under the streaming need at this size (two live
    # activations and the logits) and over a cube's, with no crop model
    # (its full-volume forward is charged whole).
    need_stream = math.prod(shape) * (2 * cfg.channels + cfg.num_classes) * 4
    need_cube = (cube + 2 * overlap) ** 3 * (2 * cfg.channels + cfg.num_classes) * 4
    budget = MemoryBudget((need_stream + need_cube) // 2, name="f1_probe")
    tight = SegmentationEngine(
        params, PipelineConfig(name="gwm_light", model=cfg, volume_shape=shape, cube=cube, overlap=overlap),
        budget=budget, device=dev,
    )
    mode = tight.pick_mode(shape)
    res, counts = count_launches(dev, lambda: tight.submit(vol))
    rec = res.record
    print(f"F1 probe: budget {budget.bytes_limit} bytes (streaming needs {need_stream}, a cube {need_cube}); "
          f"pick_mode {mode}; status {rec.status} mode {rec.mode} launches {counts}; stages {stages(rec)}")
    check(mode == "subvolume" and rec.status == "ok" and rec.mode == "subvolume", f"F1 probe: {mode} {rec.status} {rec.fail_type}")
    ncubes = math.prod(-(-s // cube) for s in shape)
    check(counts == {"K1": 9 * ncubes if cuda else 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}, f"F1 probe launches {counts}")
    return out


def phase_reduced_times(dev, card: str, size: int) -> tuple[list[dict], list[dict]]:
    print(f"== phase 9d: K1r and K2r times at the main path's shapes ({size}^3, card: {card})")
    _, peak_fp32, peak_bw = peaks_for(card)
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    per_forward = {}
    cin = cfg.in_channels
    for d in cfg.dilations:
        per_forward[(d, cin)] = per_forward.get((d, cin), 0) + 1
        cin = cfg.channels
    gen = torch.Generator().manual_seed(SEED + 93)
    rows = []
    shape = (1, size, size, size)
    for (d, cin), count in sorted(per_forward.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        cout = cfg.channels
        for w_int8 in (False, True):
            x, w, b, s, o = reduced_inputs(gen, shape, cin, cout, w_int8, dev)
            kw = dict(dilation=d, scale=s, offset=o, fuse_affine=True)
            kernel_ms = time_ms(lambda: k1.dilated_conv3d(x, w, b, **kw))
            dev_ms = device_ms(lambda: k1.dilated_conv3d(x, w, b, **kw))
            plain_ms = time_ms(lambda: ref.dilated_conv3d(x, w, b, **kw), runs=5)
            x_ncdhw = x.permute(0, 4, 1, 2, 3)  # a view: the data stays channels-last
            w_oidhw = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous()  # int8 codes are exact in bf16
            b16 = b.to(torch.bfloat16)
            library_ms = time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, b16, padding=d, dilation=d))
            ops_, bytes_ = k1r_work(shape, cin, cout, d, 1 if w_int8 else 2)
            t_ops, t_bytes = ops_ / BF16_TC_PEAK * 1e3, bytes_ / peak_bw * 1e3
            bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            regs, spills = k1.lp_registers(cin, cout, d, w_int8)
            per_sm = k1.lp_blocks_per_sm(cin, cout, d, w_int8)
            check(k1.lp_library_tile(cin, cout, d) == k1.lp_tile(cin, cout, d)
                  and per_sm == k1.lp_blocks_per_sm_model(cin, cout, d, regs),
                  f"K1r {cin}->{cout} d={d}: the library's tile or blocks an SM differ from the Python mirror's")
            check(spills == 0, f"K1r {cin}->{cout} d={d}: {spills} bytes of local memory a thread (spills)")
            row = dict(
                dilation=d, cin=cin, cout=cout, weights="int8" if w_int8 else "bf16", launches_per_forward=count,
                kernel_ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / kernel_ms, fp32_cuda_core_ms=ops_ / peak_fp32 * 1e3,
                tile=list(k1.lp_tile(cin, cout, d)), smem_bytes=k1.lp_smem_bytes(cin, cout, d), registers=regs,
                spill_bytes=spills, blocks_per_sm=per_sm, tiles=k1.lp_tile_count(shape, cin, cout, d),
                staged_rows=k1.lp_staged_rows(shape, cin, cout, d), ops=ops_, bytes=bytes_,
            )
            print("times K1r " + json.dumps(row))
            rows.append(row)
            del x
    for weights in ("bf16", "int8"):
        mine = [r for r in rows if r["weights"] == weights]
        total = lambda key: sum(r[key] * r["launches_per_forward"] for r in mine)  # noqa: E731
        print(f"times K1r forward {weights} weights: kernels {total('kernel_ms'):.4f} ms (CUDA events; device time "
              f"{total('device_ms'):.4f}), bound {total('bound_ms'):.4f}, F.conv3d {total('library_ms'):.4f}, "
              f"plain {total('plain_ms'):.4f} (9 launches, one gwm_light forward at {size}^3)")
    params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    xs = conform.conform(vol, (size,) * 3)[None]
    for precision in ("fp32", "bf16", "int8w"):
        prepared = quantize.prepare_params(params, cfg, precision)
        ms = time_ms(lambda: ops.meshnet_apply(prepared, xs, cfg, precision=precision))
        print(f"times forward cuda_fused {precision}: {ms:.4f} ms (one gwm_light forward at {size}^3, params prepared)")

    # K2r: every segment of the 256^3 plan at each policy on the staging
    # array it reads, a call's CUDA-event time (``time_ms``, as every
    # kernel's; its device time, ``device_ms``, beside it); its bound counts the function's own work
    # at the policy's widths, its operations at the bf16 tensor-core rate;
    # the library's bf16 conv (F.conv3d, cuDNN) over the same layers
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k2r_rows = []
    for precision in ("bf16", "int8w"):
        prepared = quantize.prepare_params(params, cfg, precision)
        scales = quantize.staging_scales_from_bn(prepared, cfg) if precision == "int8w" else None
        pln = k2.plan_for_config(cfg, (size,) * 3, precision=precision)
        for i, act, operands in k2r_stagings(pln, prepared, cfg, xs[..., None], precision, scales):
            seg = pln.segments[i]
            kernel_ms = time_ms(lambda: k2.run_segment(act, pln, i, *operands))
            dev_ms = device_ms(lambda: k2.run_segment(act, pln, i, *operands))
            plain_ms = time_ms(lambda: ref.megakernel_segment(act, pln, i, *operands), runs=5)
            library_ms = band_conv_ms(act, pln, params, cfg, i, None, torch.bfloat16)
            ops_, bytes_ = k2r_work(pln, i)
            bound_ms, bound_by = bound(ops_, bytes_, BF16_TC_PEAK, peak_bw)
            macs, modeled = pln.segment_operations(i), pln.segment_hbm_bytes(i)
            plan_bound_ms, plan_bound_by = bound(2 * macs, modeled, BF16_TC_PEAK, peak_bw)
            smem = int(k2._segment_smem_bytes(seg, pln.widths, pln.stage(i)))
            blocks, per_sm = pln.segment_blocks(i), k2.blocks_per_sm(seg, pln.widths, pln.stage(i))
            check(per_sm == int(k2._blocks_per_sm(smem, seg.channels, pln.widths)),
                  f"K2r segment {i}: the planner's blocks an SM differ from the runtime's {per_sm}")
            tc_macs, in_rows, pairs = k2._lp_segment_work(seg, pln.vol, 1, pln.widths, pln.stage(i))
            row = dict(
                precision=precision, segment=i, dilations=list(seg.dilations), tile=list(seg.tile),
                fuse_head=seg.fuse_head, staging=[str(t).replace("torch.", "") for t in pln.dtypes(i)],
                dequantises=bool(k2.scale_operands(pln, i)[0]), smem_bytes=smem, blocks=blocks, blocks_per_sm=per_sm,
                waves=blocks / (sms * per_sm), registers=k2.REGISTERS_LP[seg.channels], kernel_ms=kernel_ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / kernel_ms, fp32_cuda_core_ms=ops_ / peak_fp32 * 1e3,
                modeled_ms=pln.segment_modeled_ms(i), tensor_core_macs=float(tc_macs), input_rows=float(in_rows), row_pairs=float(pairs),
                ops=ops_, bytes=bytes_, plan_bound_ms=plan_bound_ms, plan_bound_by=plan_bound_by, multiply_adds=macs,
                modeled_bytes=modeled,
            )
            print("times K2r " + json.dumps(row))
            k2r_rows.append(row)
        mine = [r for r in k2r_rows if r["precision"] == precision]
        print(f"times K2r plan {precision}: {plan_text(pln)}; modeled {pln.modeled_ms():.4f} ms (segments "
              f"{sum(r['modeled_ms'] for r in mine):.4f}); kernels {sum(r['kernel_ms'] for r in mine):.4f} ms (CUDA "
              f"events; device time {sum(r['device_ms'] for r in mine):.4f}); F.conv3d {sum(r['library_ms'] for r in mine):.4f} ms")
    for precision in ("fp32", "bf16", "int8w"):
        prepared = quantize.prepare_params(params, cfg, precision)
        ms = time_ms(lambda: ops.meshnet_apply_megakernel(prepared, xs, cfg, precision=precision))
        print(f"times forward cuda_megakernel {precision}: {ms:.4f} ms (one gwm_light forward at {size}^3, "
              "params prepared)")
    print_clocks()
    return rows, k2r_rows


# ------------------------------------------- phase 10: the sharded executors ---

SLABS = 4  # phase 10's Z-slab count
SHARD_REDUCED_GATE = 2e-2  # sharded against single-device at bf16 and int8w (tests/test_precision.py:266)


def slab_devices(dev, n: int) -> list:
    """n slab devices: cuda:0 .. n-1 where the host has them, else the one
    card (or the CPU in a rehearsal) n times."""
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def slab_windows(x: torch.Tensor, cfg, n: int, precision: str) -> list:
    """The megakernel inner's windows of ``x`` (B, D, H, W): its n slabs at
    the policy's input type (int8 codes under int8w, bf16 under bf16), each
    with the receptive-field radius of its neighbours' rows a side, as
    spatial_shard's one-shot exchange makes them; then (window, z_bounds)."""
    x = x[..., None]
    if precision == "int8w":
        x = quantize.quantize_input(x)
    elif precision == "bf16":
        x = x.to(torch.bfloat16)
    dloc, radius = x.shape[1] // n, sum(cfg.dilations)
    windows = spatial_shard.halo_exchange_z(list(x.split(dloc, 1)), radius)
    return [(w, spatial_shard.window_z_bounds(i, dloc, n, radius)) for i, w in enumerate(windows)]


def junk_outside(t: torch.Tensor, vol, lo: int, hi: int, h: int) -> torch.Tensor:
    """A copy of staging array ``t`` (the volume ``vol`` at offset h) with
    its border poisoned and the volume's rows outside [lo, hi) junk: NaN
    (fp32, bf16) or the code 100 (int8), rows no bounded kernel may read."""
    region = (slice(None),) + tuple(slice(h, h + v) for v in vol) + (slice(None),)
    out = poisoned(t, region)
    junk = 100 if t.dtype == torch.int8 else float("nan")
    out[:, h : h + lo, h : h + vol[1], h : h + vol[2]] = junk
    out[:, h + hi : h + vol[0], h : h + vol[1], h : h + vol[2]] = junk
    return out


def k2z_stagings(pln, params, cfg, window: torch.Tensor, bounds, precision: str, scales, rows=None):
    """Yield (i, input staging, operands, band) for every segment of a
    window's plan: the first staging the window, each later one K2z's
    (K2r-z's) output of the segment before; every border poisoned and every
    row outside the bounds junk. With ``rows`` (the slab's kept rows) each
    segment runs on its band (``megakernel.segment_bands``), and the rows
    of its input outside the band before it, which no launch writes, are
    junk too. ``params`` prepared for ``precision``."""
    first = pln.segments[0]
    h = first.halo
    lo, hi = ref.z_interval(pln.vol[0], bounds)
    bands = k2.segment_bands(pln, rows, bounds) if rows is not None else [None] * len(pln.segments)
    act = torch.zeros((window.shape[0],) + tuple(p + 2 * h for p in pln.padded(first)) + (window.shape[-1],),
                      dtype=window.dtype, device=window.device)
    act[:, h : h + pln.vol[0], h : h + pln.vol[1], h : h + pln.vol[2]] = window
    for i, seg in enumerate(pln.segments):
        layers, head = ops.megakernel_operands(params, cfg, seg, precision)
        deq, qs = k2.scale_operands(pln, i) if precision != "fp32" else (False, False)
        operands = (layers, head, scales[seg.start - 1] if deq else None,
                    scales[seg.start + len(seg.dilations) - 1] if qs else None)
        if i > 0 and rows is not None:  # the rows the band before left unwritten
            act = junk_outside(act, pln.vol, max(lo, bands[i - 1][0]), min(hi, bands[i - 1][1]), seg.halo)
        else:
            act = junk_outside(act, pln.vol, lo, hi, seg.halo)
        yield i, act, operands, bands[i]
        if i + 1 < len(pln.segments):
            act = k2.run_segment(act, pln, i, *operands, z_bounds=bounds, band=bands[i])


def sharded_models(dev, size: int):
    gen = torch.Generator().manual_seed(SEED + 10)
    cfg = meshnet.PAPER_MODELS["gwm_light"]
    params = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
    vol, _ = mri.generate(gen, mri.SyntheticMRIConfig(shape=(size,) * 3), device=dev)
    return cfg, params, vol, conform.conform(vol, (size,) * 3)[None]


def phase_sharded_parity(dev, size: int) -> dict:
    print(f"== phase 10a: K2z and K2r-z against their plain versions on the {SLABS}-slab windows at {size}^3 "
          "(the first and last slabs: the volume's ends inside the window), segment by segment on the bands their "
          "kept rows need, rows outside the bounds and the rows no band writes junk; the kept rows against the whole "
          "window's, bit for bit")
    cfg, params, _, x = sharded_models(dev, size)
    worst = {"fp32": 0.0, "bf16": 0.0}  # the largest fp32 and bf16 differences (int8 codes: within 1)
    radius, dloc = sum(cfg.dilations), size // SLABS
    for precision in ("fp32", "bf16", "int8w"):
        prepared = quantize.prepare_params(params, cfg, precision)
        scales = quantize.staging_scales_from_bn(prepared, cfg) if precision == "int8w" else None
        windows = slab_windows(x, cfg, SLABS, precision)
        for slab, which in ((0, "planner's"), (SLABS - 1, "planner's"), (0, "forced")):
            window, bounds = windows[slab]
            vol = tuple(window.shape[1:4])
            pln = k2.plan_for_config(cfg, vol, precision=precision)
            if which == "forced":  # multi-layer segments: the per-layer mask inside a segment acts
                pln = forced_k2r_plan(cfg, vol, pln.widths)
            kept = {}
            for rows in (None, (radius, radius + dloc)):
                for i, act, operands, band in k2z_stagings(pln, prepared, cfg, window, bounds, precision, scales, rows):
                    seg = pln.segments[i]
                    out = k2.run_segment(act, pln, i, *operands, z_bounds=bounds, band=band)
                    synchronize(dev)
                    if i + 1 == len(pln.segments):  # the slab's kept rows
                        kept[rows] = out[:, radius : radius + dloc, : vol[1], : vol[2]].clone()
                    if rows is None:  # the whole window: its kept rows only (the card tests hold it segment by segment)
                        continue
                    lo, hi = k2.band_rows(pln, i, band)
                    o = pln.out_halo(i)
                    region = (slice(None), slice(o + lo, o + hi)) + written(pln, i)[2:]
                    got = out[region]
                    expect = ref.megakernel_segment(act, pln, i, *operands, z_bounds=bounds, band=band)[region]
                    check(bool(torch.isfinite(got.float()).all()), f"K2z {precision} slab {slab} segment {i} finite")
                    if precision == "fp32":
                        diff, rel = rel_err(got, expect)
                        ok, what = rel <= KERNEL_REL_TOL, f"max_abs_err {diff:.3e} rel {rel:.3e}"
                    else:
                        ok, what, diff = lp_gap(got, expect)
                    print(f"K2z {precision} slab {slab} window {vol} bounds {bounds} {which} plan segment "
                          f"{i}/{len(pln.segments)} dilations {seg.dilations} tile {seg.tile} rows {[lo, hi]}: {what}")
                    check(ok, f"K2z {precision} slab {slab} segment {i} rows {[lo, hi]}: {what}")
                    if got.dtype != torch.int8:
                        key = "fp32" if got.dtype == torch.float32 else "bf16"
                        worst[key] = max(worst[key], diff)
                    del out, got, expect
            same = torch.equal(kept[None], kept[(radius, radius + dloc)])
            print(f"K2z {precision} slab {slab} {which} plan: the kept rows on bands bit-equal to the whole window's: "
                  f"{same}")
            check(same, f"K2z {precision} slab {slab} {which}: banded kept rows differ from the whole window's")
    return worst


def phase_sharded(dev, size: int, rehearsal: bool) -> dict:
    devices = slab_devices(dev, SLABS)
    print(f"== phase 10b: the sharded executors at {size}^3, gwm_light full width, {SLABS} slabs on "
          f"{[str(d) for d in devices]}: main paths, held to the single-device executors")
    cfg, params, vol, x = sharded_models(dev, size)
    cuda = dev.type == "cuda"
    window = (size // SLABS + 2 * sum(cfg.dilations), size, size)
    out = {"K2z": 0}
    for precision in ("fp32", "bf16", "int8w"):
        single = executors.apply("cuda_megakernel", params, x, cfg, precision=precision).float()
        got, counts = count_launches(dev, lambda: spatial_shard.sharded_executor_apply(
            "cuda_megakernel", params, x, cfg, precision=precision, devices=devices))
        # the same windows without bands, cropped: the kept rows bit for bit
        prepared, radius = quantize.prepare_params(params, cfg, precision), sum(cfg.dilations)
        whole = torch.cat([ops.meshnet_apply_megakernel(prepared, w, cfg, precision=precision, z_bounds=b)[
            :, radius : radius + size // SLABS] for w, b in slab_windows(x, cfg, SLABS, precision)], 1)
        same = torch.equal(got, whole)
        print(f"sharded_cuda_megakernel@{SLABS} {precision}: on bands bit-equal to the whole windows cropped: {same}")
        check(same, f"sharded megakernel {precision}: the banded forward differs from the whole windows'")
        del whole
        got = got.float()
        whole = k2.plan_for_config(cfg, tuple(x.shape[1:4]), precision=precision)
        part = k2.plan_for_config(cfg, window, precision=precision)
        print(f"sharded_cuda_megakernel@{SLABS} {precision}: single-device plan {plan_text(whole)}; window plan "
              f"{plan_text(part)}")
        segs = len(part.segments)
        expect = {"K1": 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": SLABS * segs if cuda else 0}
        err, agree = logit_gap(got, single)
        top = float(single.abs().max())
        print(f"sharded_cuda_megakernel@{SLABS} {precision}: launches {counts} ({SLABS} windows x {segs} segments of "
              f"the {window} plan); vs single-device cuda_megakernel max_abs {err:.4e} (largest logit {top:.4f}, "
              f"argmax agrees {agree:.6%})")
        check(counts == expect, f"sharded megakernel {precision} launches {counts}, expected {expect}")
        check(tuple(got.shape) == tuple(single.shape) and bool(torch.isfinite(got).all()),
              f"sharded megakernel {precision} logits {tuple(got.shape)}")
        gate = MEGA_FORWARD_REL_TOL if precision == "fp32" else SHARD_REDUCED_GATE
        check(err <= gate * top, f"sharded megakernel {precision}: {err} > {gate} x {top}")
        if precision == "fp32":
            check(agree == 1.0, f"sharded megakernel fp32 segmentation differs from the single-device one: {agree}")
        out["K2z"] += counts["K2z"]
        del single, got
    single = executors.apply("cuda_fused", params, x, cfg)
    got, counts = count_launches(dev, lambda: spatial_shard.sharded_executor_apply(
        "cuda_fused", params, x, cfg, devices=devices))
    err, agree = logit_gap(got, single)
    top = float(single.abs().max())
    expect = {"K1": SLABS * len(cfg.dilations) if cuda else 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}
    print(f"sharded_cuda_fused@{SLABS} fp32: launches {counts}; vs single-device cuda_fused max_abs {err:.4e} "
          f"(largest logit {top:.4f}, argmax agrees {agree:.6%})")
    check(counts == expect, f"sharded fused launches {counts}, expected {expect}")
    check(err <= MEGA_FORWARD_REL_TOL * top and agree == 1.0, f"sharded fused: {err}, argmax {agree}")
    del single, got
    # the pipeline, as a user asks for slabs: served where the host has the
    # cards, else a typed shard_geometry failure
    pc = PipelineConfig(model=cfg, volume_shape=(size,) * 3, executor="cuda_megakernel" if cuda else "torch",
                        shard_devices=SLABS)
    res, counts = count_launches(dev, lambda: pipeline.run(pc, params, vol, device=dev))
    rec = res.record
    print(f"pipeline.run(shard_devices={SLABS}): status {rec.status} fail_type {rec.fail_type} executor {rec.executor} "
          f"launches {counts}; collective bytes modeled {rec.collective_bytes_modeled}; modeled bytes "
          f"{rec.hbm_bytes_modeled}; devices on this host {spatial_shard.device_count(dev.type)}")
    check(rec.executor == executors.sharded_name(executors.inner_of(pc.executor), SLABS), f"executor {rec.executor}")
    if spatial_shard.device_count(dev.type) >= SLABS:
        check(rec.status == "ok" and rec.collective_bytes_modeled > 0, f"pipeline: {rec.status} {rec.fail_type}")
    else:
        check((rec.status, rec.fail_type) == ("fail", "shard_geometry"), f"pipeline: {rec.status} {rec.fail_type}")
        check(sum(counts.values()) == 0, f"a refused request launched {counts}")
    return out


def band_conv_ms(x: torch.Tensor, pln, params, cfg, i: int, band, dtype) -> float:
    """CUDA-event median of the library's conv (``F.conv3d``, cuDNN; TF32
    off; milliseconds a call, so the host's time is hidden) over segment
    i's layers on the rows its band needs: its input's rows
    within the segment's halo of the band, each layer a valid-Z conv
    ('same' in Y and X) at ``dtype``, so that the output is the band's
    rows. Timed beside K2z; the port never calls it."""
    seg = pln.segments[i]
    lo, hi = k2.band_rows(pln, i, band)
    rows = hi - lo + 2 * seg.halo
    gen = torch.Generator().manual_seed(SEED + i)
    convs = []
    cin = seg.cin
    for li, d in enumerate(seg.dilations):
        w = params["layers"][seg.start + li]["w"].float().permute(4, 3, 0, 1, 2).contiguous().to(dtype)
        inp = torch.rand((x.shape[0], cin, rows, pln.vol[1], pln.vol[2]), generator=gen).to(x.device, dtype)
        inp = inp.to(memory_format=torch.channels_last_3d)
        convs.append((inp, w, d))
        rows -= 2 * d
        cin = seg.channels
    return time_ms(lambda: [F.conv3d(inp, w, None, padding=(0, d, d), dilation=d) for inp, w, d in convs], runs=5)


def phase_sharded_times(dev, card: str, size: int) -> list[dict]:
    print(f"== phase 10c: K2z and K2r-z times on the {SLABS} windows (each segment on the band of rows its slab "
          f"keeps), and the sharded forwards beside the single-device ones ({size}^3, card: {card})")
    _, peak_fp32, peak_bw = peaks_for(card)
    cfg, params, _, x = sharded_models(dev, size)
    devices = slab_devices(dev, SLABS)
    radius, dloc = sum(cfg.dilations), size // SLABS
    rows = []
    for precision in ("fp32", "bf16", "int8w"):
        prepared = quantize.prepare_params(params, cfg, precision)
        scales = quantize.staging_scales_from_bn(prepared, cfg) if precision == "int8w" else None
        for slab, (window, bounds) in enumerate(slab_windows(x, cfg, SLABS, precision)):
            pln = k2.plan_for_config(cfg, tuple(window.shape[1:4]), precision=precision)
            for i, act, operands, band in k2z_stagings(pln, prepared, cfg, window, bounds, precision, scales,
                                                       (radius, radius + dloc)):
                kernel_ms = time_ms(lambda: k2.run_segment(act, pln, i, *operands, z_bounds=bounds, band=band))
                dev_ms = device_ms(lambda: k2.run_segment(act, pln, i, *operands, z_bounds=bounds, band=band))
                plain_ms = time_ms(lambda: ref.megakernel_segment(act, pln, i, *operands, z_bounds=bounds, band=band),
                                   runs=1, warmup=1)
                fp32 = precision == "fp32"
                library_ms = band_conv_ms(act, pln, params, cfg, i, band, torch.float32 if fp32 else torch.bfloat16)
                work = k2_work if fp32 else k2r_work
                peak = peak_fp32 if fp32 else BF16_TC_PEAK
                ops_, bytes_ = k2z_work(work, pln, i, bounds, band)
                bound_ms, bound_by = bound(ops_, bytes_, peak, peak_bw)
                ops_z, bytes_z = k2z_work(work, pln, i, bounds)
                bound_z_ms, bound_z_by = bound(ops_z, bytes_z, peak, peak_bw)
                seg = pln.segments[i]
                row = dict(precision=precision, slab=slab, bounds=list(bounds), band=list(k2.band_rows(pln, i, band)),
                           segment=i, dilations=list(seg.dilations), tile=list(seg.tile), blocks=pln.segment_blocks(i),
                           kernel_ms=kernel_ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / kernel_ms,
                           bound_zbounds_ms=bound_z_ms, bound_zbounds_by=bound_z_by,
                           modeled_ms=pln.segment_modeled_ms(i), ops=ops_, bytes=bytes_)
                print("times K2z " + json.dumps(row))
                rows.append(row)
        mine = [r for r in rows if r["precision"] == precision]
        print(f"times K2z {precision}: {len(mine)} launches a {SLABS}-slab forward, kernels "
              f"{sum(r['kernel_ms'] for r in mine):.4f} ms (CUDA events; device time "
              f"{sum(r['device_ms'] for r in mine):.4f}), plain {sum(r['plain_ms'] for r in mine):.4f} "
              f"ms, F.conv3d {sum(r['library_ms'] for r in mine):.4f} ms, bound {sum(r['bound_ms'] for r in mine):.4f} "
              f"ms over the bands ({sum(r['bound_zbounds_ms'] for r in mine):.4f} over the rows inside z_bounds)")
    for inner, policies in (("cuda_megakernel", ("fp32", "bf16", "int8w")), ("cuda_fused", ("fp32", "bf16", "int8w"))):
        for precision in policies:
            prepared = quantize.prepare_params(params, cfg, precision)
            one = time_ms(lambda: executors.apply(inner, prepared, x, cfg, precision=precision), runs=10)
            many = time_ms(lambda: spatial_shard.sharded_executor_apply(
                inner, prepared, x, cfg, precision=precision, devices=devices), runs=10)
            print(f"times forward {inner} {precision}: single-device {one:.4f} ms; sharded over {SLABS} slabs on "
                  f"{len(set(devices))} card(s) {many:.4f} ms ({many / one:.3f}x; one gwm_light forward at {size}^3, "
                  "slabs in turn, the halo exchange and the crop included)")
    print_clocks()
    return rows


# ------------------------------------------- phase 11: queued serving ---

#: phase 11's drained requests: (priority class, executor, precision); a
#: garbage 1-D volume follows them
QUEUED = (
    ("interactive", None, None),
    ("interactive", None, None),
    ("standard", None, "bf16"),
    ("standard", None, "int8w"),
    ("batch", "cuda_megakernel", None),
)
CLASS_RANK = {"interactive": 0, "standard": 1, "batch": 2}


def card_line(rehearsal: bool) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if rehearsal:
        return "no card (cpu rehearsal)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip()


def implied_launches(rec, cfg, mcfg, shape, cube: int, overlap: int) -> dict:
    """The launches a served request's record implies: one K1 (K1r at a
    reduced policy) a layer of each forward under cuda_fused, one K2 (K2r)
    a segment of each forward's plan under cuda_megakernel; the mask
    model's forward over the whole volume, the main model's over the crop
    or, in mode subvolume, over each cube of it."""
    out = {"K1": 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}
    reduced = rec.precision != "fp32"
    sub = rec.mode == "subvolume"
    region = rec.crop_size or shape
    ncubes = math.prod(-(-s // cube) for s in region) if sub else 1
    main = (cube + 2 * overlap,) * 3 if sub else region
    if rec.executor == "cuda_fused":
        out["K1r" if reduced else "K1"] = (len(mcfg.dilations) if mcfg else 0) + ncubes * len(cfg.dilations)
    elif rec.executor == "cuda_megakernel":
        segs = len(k2.plan_for_config(cfg, main, precision=rec.precision).segments)
        mask = len(k2.plan_for_config(mcfg, shape, precision=rec.precision).segments) if mcfg else 0
        out["K2r" if reduced else "K2"] = mask + ncubes * segs
    return out


def summed(dicts) -> dict:
    out = {"K1": 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}
    for d in dicts:
        for k, v in d.items():
            out[k] += v
    return out


def phase_queued(dev, size: int, rehearsal: bool) -> dict:
    cube, overlap = (8, 4) if rehearsal else (CUBE, OVERLAP)
    card = card_line(rehearsal)
    print(f"== phase 11: queued serving through the request scheduler at {size}^3 (card: {card})")
    cfg, mcfg, params, mparams, vols, _ = served_models(dev, size)
    shape = (size,) * 3
    gen = torch.Generator().manual_seed(SEED + 11)
    vols = vols + [mri.generate(gen, mri.SyntheticMRIConfig(shape=shape), device=dev)[0] for _ in range(2)]
    engine = SegmentationEngine(
        params,
        PipelineConfig(name="gwm_light", model=cfg, volume_shape=shape, use_cropping=True, cube=cube, overlap=overlap),
        mask_model=(mparams, mcfg), device=dev,
    )
    cuda = dev.type == "cuda"
    fused = "cuda_fused" if cuda else "torch"
    out = {}

    print("-- 11a: submit_async, then drain: 2 interactive fp32 (auto), a bf16 and an int8w standard, a batch "
          "fp32 under cuda_megakernel, a garbage 1-D volume")
    unl = MemoryBudget.unlimited()
    fp32_price = unl.charge_streaming(shape, cfg, dtype_bytes=4)
    bf16_price = unl.charge_streaming(shape, cfg, dtype_bytes=2)
    sub_price = unl.charge_subvolume(cube, overlap, cfg, dtype_bytes=4)
    # at or above the bf16 price and under the fp32 one, and room for the
    # two interactive requests' demoted forms in one group
    cap = max(bf16_price, 2 * sub_price)
    check(cap < fp32_price, f"no admission budget demotes fp32 alone at {size}^3")
    sched = engine.scheduler(SchedulerConfig(admission_hbm_bytes=cap, max_batch_requests=4))
    print(f"admission budget {cap} bytes: streaming a {size}^3 request is priced {fp32_price} at fp32 and "
          f"{bf16_price} at bf16, a cube {sub_price} at fp32, so the fp32 requests demote to mode subvolume")
    asked = {}
    for (prio, executor, precision), vol in zip(QUEUED, vols):
        asked[engine.submit_async(vol, priority=prio, executor=executor, precision=precision)] = (
            prio, executor, precision, vol)
    garbage = engine.submit_async(torch.zeros(3, device=dev), priority="standard")
    t0 = time.perf_counter()
    comps, counts = count_launches(dev, engine.drain)
    drain_s = time.perf_counter() - t0
    st = sched.stats
    print(f"drained {len(comps)} requests in {drain_s * 1e3:.3f} ms host clock ({card}); batches {st.batches}, "
          f"completed {st.completed}, demoted {st.demoted}, rejected {st.rejected}, permanent faults "
          f"{st.permanent_faults}; launches {counts}")
    check(st.conserved() and st.admitted == len(QUEUED) + 1 and len(comps) == len(QUEUED) + 1,
          f"the drain is not conserved: {st}")
    by_finish = sorted(comps, key=lambda c: c.finish_s)
    classes = [c.record.priority_class for c in by_finish]
    print(f"dispatch order by finish: {[(c.id, c.record.priority_class) for c in by_finish]}")
    check(classes == sorted(classes, key=CLASS_RANK.get), f"classes served out of priority order: {classes}")
    implied = []
    for c in comps:
        rec = c.record
        if c.id == garbage:
            error = rec.extra.get("error", "")
            print(f"garbage request {c.id}: outcome {c.outcome} status {rec.status} fail_type {rec.fail_type}; {error}")
            check(rec.status == "fail" and rec.fail_type == "permanent_fault" and c.result is None,
                  f"the garbage request is not a typed permanent fault: {rec.status} {rec.fail_type}")
            check("kernel" not in error, f"the garbage request failed in a kernel: {error}")
            continue
        prio, executor, precision, vol = asked[c.id]
        # the scheduler isolates every exception as a typed failure record,
        # so a kernel that fails to build or launch would land here
        check(rec.status == "ok", f"request {c.id} ({prio}) failed: {rec.fail_type} {rec.extra.get('error')}")
        want = "cuda_megakernel" if executor == "cuda_megakernel" else fused
        check(rec.executor == want and rec.precision == (precision or "fp32") and rec.priority_class == prio,
              f"request {c.id} stamped {rec.executor} {rec.precision} {rec.priority_class}")
        check(rec.batch_size == (2 if prio == "interactive" else 1), f"request {c.id} batch size {rec.batch_size}")
        demoted = precision is None
        check(c.outcome == ("demoted" if demoted else "completed") and rec.demoted == demoted
              and rec.mode == ("subvolume" if demoted else "streaming"),
              f"request {c.id} outcome {c.outcome} mode {rec.mode}")
        check(abs(rec.queue_wait_s + rec.service_s - (c.finish_s - c.arrival_s)) <= 1e-6,
              f"request {c.id}: queue_wait_s + service_s != finish - arrival")
        implied.append(implied_launches(rec, cfg, mcfg, shape, cube, overlap) if cuda else {})
        synchronize(dev)
        t0 = time.perf_counter()
        again = engine.submit(vol, mode=rec.mode, executor=rec.executor, precision=rec.precision)
        synchronize(dev)
        submit_ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(c.result.segmentation, again.segmentation)
        print(f"queued request {c.id} {prio} {rec.precision} {rec.executor}: outcome {c.outcome} mode {rec.mode} "
              f"crop {rec.crop_size} batch {rec.batch_size}; queue wait {rec.queue_wait_s * 1e3:.3f} ms, service "
              f"{rec.service_s * 1e3:.3f} ms host clock; submit of the same request {submit_ms:.3f} ms; equal "
              f"{same} ({card})")
        check(same, f"request {c.id}'s segmentation differs from submit's")
    expect = summed(implied)
    check(counts == expect, f"drained launches {counts}, the served requests imply {expect}")
    out["drain"] = counts

    print("-- 11b: submit_many of 3 volumes, precisions None, bf16, int8w")
    precisions = [None, "bf16", "int8w"]
    made = []
    init = RequestScheduler.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    RequestScheduler.__init__ = recording
    try:
        t0 = time.perf_counter()
        results, counts = count_launches(dev, lambda: engine.submit_many(vols[:3], precisions=precisions))
        many_s = time.perf_counter() - t0
    finally:
        RequestScheduler.__init__ = init
    stats = made[0].stats
    print(f"submit_many: {len(results)} results in {many_s * 1e3:.3f} ms host clock ({card}); resolutions "
          f"{stats.resolutions}, batches {stats.batches}; launches {counts}")
    check(len(made) == 1 and stats.resolutions == len(set(precisions)) and stats.conserved(),
          f"submit_many resolved {stats.resolutions} signatures, {len(set(precisions))} distinct")
    implied = []
    for i, (res, precision) in enumerate(zip(results, precisions)):
        rec = res.record
        check(rec.extra.get("request_index") == i and rec.status == "ok" and rec.precision == (precision or "fp32")
              and rec.executor == fused, f"submit_many result {i}: {rec.status} {rec.precision} {rec.executor}")
        implied.append(implied_launches(rec, cfg, mcfg, shape, cube, overlap) if cuda else {})
        again = engine.submit(vols[i], precision=precision)
        check(torch.equal(res.segmentation, again.segmentation), f"submit_many result {i} differs from submit's")
    expect = summed(implied)
    check(counts == expect, f"submit_many launches {counts}, the served requests imply {expect}")
    out["submit_many"] = counts

    print("-- 11c: the load simulator's steady preset, 60 virtual seconds, executed on reference_engine")
    sim_engine = simulator.reference_engine(device=dev)
    cfg_sim = simulator.preset("steady", horizon_s=60.0)
    cfg_sim.execute = True
    t0 = time.perf_counter()
    rep, counts = count_launches(dev, lambda: simulator.simulate(sim_engine, cfg_sim))
    wall = time.perf_counter() - t0
    summary = rep.summary()
    print(f"simulator steady: {rep.arrived} arrivals, {summary['requests']}, batches {summary['batches']}, in "
          f"{wall:.3f} s wall ({card}); virtual latency ms {summary['latency_ms']}; launches {counts}")
    check(rep.scheduler.stats.conserved(), "the simulated run is not conserved")
    garbage_ids = set()
    for c in rep.completions:
        rec = c.record
        if rec.mode == "none":
            garbage_ids.add(c.id)
            check(rec.status == "fail" and rec.fail_type == "permanent_fault", f"simulated garbage {c.id}: {rec.fail_type}")
        else:
            check(rec.status == "ok" and rec.executor == fused,
                  f"simulated request {c.id}: {rec.status} {rec.executor} {rec.fail_type} {rec.extra.get('error')}")
    check(bool(garbage_ids) or rehearsal, "the simulated trace had no garbage request")
    check(not cuda or (counts["K1"] > 0 and counts["K1r"] > 0), f"the simulator launched {counts}")
    out["simulate"] = counts
    return out


# ------------------------------- phase 12: resilience and the artifact cache ---


def cuda_bytes(dev) -> int:
    """Bytes the caching allocator holds for live tensors (0 on the CPU)."""
    synchronize(dev)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def owned(comps) -> bool:
    """Whether no two completions' segmentations share storage."""
    ptrs = [c.result.segmentation.data_ptr() for c in comps]
    return len(set(ptrs)) == len(ptrs)


def phase_resilience(dev, size: int, rehearsal: bool) -> dict:
    t_phase = time.perf_counter()
    cube, overlap = (8, 4) if rehearsal else (CUBE, OVERLAP)
    card = card_line(rehearsal)
    print(f"== phase 12: resilience and the artifact cache behind the scheduler at {size}^3 (card: {card})")
    cfg, mcfg, params, mparams, vols, _ = served_models(dev, size)
    shape = (size,) * 3
    gen = torch.Generator().manual_seed(SEED + 12)
    vols = vols + [mri.generate(gen, mri.SyntheticMRIConfig(shape=shape), device=dev)[0] for _ in range(2)]
    pc = PipelineConfig(name="gwm_light", model=cfg, volume_shape=shape, use_cropping=True, cube=cube, overlap=overlap)

    def engine_for(pcfg=pc):
        return SegmentationEngine(params, pcfg, mask_model=(mparams, mcfg), device=dev)

    cuda = dev.type == "cuda"
    fused = "cuda_fused" if cuda else "torch"
    zero = {"K1": 0, "K1r": 0, "K2": 0, "K2r": 0, "K2z": 0}
    out = {}
    t_12a = time.perf_counter()
    print(f"set-up (the served models and two more {size}^3 volumes) took {t_12a - t_phase:.1f} s")

    print("-- 12a: an ArtifactCache: one volume queued 3 times and one other (interactive, fp32), then the first "
          "again, then a permanent fault on a third volume and its twin")
    a, b, c = vols[0], vols[3], vols[4]
    engine = engine_for()
    cache = ArtifactCache()
    poison = FaultPlan(seed=SEED, rules=(FaultRule(kind="permanent", rate=1.0, priority="batch"),))
    sched = engine.scheduler(SchedulerConfig(max_batch_requests=4), cache=cache, fault_plan=poison)
    base = cuda_bytes(dev)
    ids, admit_ms = [], []
    for v in [v.clone() for v in (a, a, a, b)]:
        synchronize(dev)
        t0 = time.perf_counter()
        ids.append(engine.submit_async(v, priority="interactive"))
        admit_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"admission with a cache (submit_async: content_hash of the {size}^3 fp32 volume on the {dev.type}, a copy "
          f"to the host and blake2b, then the queue): {[round(x, 3) for x in admit_ms]} ms, median "
          f"{statistics.median(admit_ms):.3f} (host clock; {card})")
    out["hash_ms"] = statistics.median(admit_ms)
    comps, counts = count_launches(dev, engine.drain)
    st = sched.stats
    by_id = {x.id: x for x in comps}
    executed = [x for x in comps if x.outcome == "completed"]
    coalesced = [x for x in comps if x.outcome == "coalesced"]
    print(f"drained {len(comps)}: {[(x.id, x.outcome, x.record.cache_hit, x.record.executor) for x in comps]}; "
          f"launches {counts}; cache {cache.summary()} ({card})")
    check(len(executed) == 2 and len(coalesced) == 2 and all(x.record.cache_hit for x in coalesced)
          and st.coalesced == 2 and st.conserved(), f"single flight: {st}")
    check(all(x.record.status == "ok" and x.record.executor == fused for x in comps),
          f"the drained requests: {[(x.record.status, x.record.executor, x.record.fail_type) for x in comps]}")
    expect = summed(implied_launches(x.record, cfg, mcfg, shape, cube, overlap) for x in executed) if cuda else zero
    check(counts == expect, f"drained launches {counts}, the two executed records imply {expect}")
    out["coalesced"] = counts
    want = {id(a): engine.submit(a).segmentation, id(b): engine.submit(b).segmentation}
    of = {ids[0]: a, ids[1]: a, ids[2]: a, ids[3]: b}
    check(all(torch.equal(x.result.segmentation, want[id(of[x.id])]) for x in comps),
          "a drained segmentation differs from submit's of the same volume")
    entries = [e.result.segmentation for e in cache.entries.values() if e.result is not None]
    check(owned(comps) and len({t.data_ptr() for t in entries} | {x.result.segmentation.data_ptr() for x in comps})
          == len(entries) + len(comps), "two completions, or a completion and the cache, share a segmentation")
    held = cuda_bytes(dev) - base
    print(f"the cache holds {len(entries)} segmentations: {sum(t.numel() * t.element_size() for t in entries)} "
          f"bytes of int32 on the {dev.type} (memory_allocated above the drain's start: {held}, with the four "
          f"completions' own {sum(x.result.segmentation.numel() * 4 for x in comps)}); modeled bytes_stored "
          f"{cache.stats.bytes_stored} (1 byte a voxel) ({card})")
    out["cache_device_bytes"] = sum(t.numel() * t.element_size() for t in entries)
    out["cache_modeled_bytes"] = cache.stats.bytes_stored

    hit_id, counts = count_launches(dev, lambda: engine.submit_async(a.clone(), priority="interactive"))
    hit = {x.id: x for x in engine.drain()}[hit_id]
    print(f"the same volume again: outcome {hit.outcome} cache_hit {hit.record.cache_hit} service "
          f"{hit.record.service_s * 1e3:.3f} ms (modeled verify); launches {counts} ({card})")
    check(counts == zero and hit.outcome == "completed" and hit.record.cache_hit and hit.record.status == "ok"
          and st.cache_hits == 1, f"the hit launched {counts} or was not a hit: {hit.outcome} {st}")
    check(torch.equal(hit.result.segmentation, want[id(a)]) and owned([hit] + comps)
          and all(hit.result.segmentation.data_ptr() != t.data_ptr() for t in entries),
          "the hit's segmentation differs from submit's or is shared")
    check(cache.stats.quarantined_served == 0, "the cache served unverified bytes")
    out["hit"] = counts

    def poisoned_then_twin():
        first = engine.submit_async(c.clone(), priority="batch")
        engine.drain()
        return first, engine.submit_async(c.clone(), priority="batch")

    (bad_id, twin_id), counts = count_launches(dev, poisoned_then_twin)
    tail = {x.id: x for x in engine.drain()}
    bad = next(x for x in sched.completions if x.id == bad_id)
    twin = tail[twin_id]
    print(f"permanent fault: {bad.record.fail_type} ({bad.record.extra.get('error')}); its twin: outcome "
          f"{twin.outcome} {twin.record.fail_type} cache_hit {twin.record.cache_hit} {twin.record.extra}; launches "
          f"{counts}; cache {cache.summary()} ({card})")
    check(bad.record.fail_type == "permanent_fault" and "injected permanent" in bad.record.extra.get("error", ""),
          f"the poisoned request: {bad.record.fail_type} {bad.record.extra}")
    check(twin.record.fail_type == "permanent_fault" and twin.record.cache_hit
          and twin.record.extra.get("negative_cache") and cache.stats.negative_hits == 1,
          f"the twin did not complete from the negative entry: {twin.record}")
    check(counts == zero, f"the injected fault and the negative hit launched {counts}")
    check(st.conserved() and cache.stats.quarantined_served == 0, f"12a: {st}")
    out["negative"] = counts
    del entries  # the cache's own references only, then measure what they hold
    before = cuda_bytes(dev)
    cache.entries.clear()
    freed = before - cuda_bytes(dev)
    print(f"clearing the cache's entries frees {freed} bytes on the {dev.type} ({card})")
    out["cache_freed_bytes"] = freed
    t_12b = time.perf_counter()
    print(f"12a took {t_12b - t_12a:.1f} s ({card})")

    print("-- 12b: the breaker on real kernels: transient faults on cuda_megakernel for 1 s from the scheduler's "
          "clock, retry 3 attempts (backoff 0.01 s), breaker trip_after 2, cooldown 1.5 s")
    engine = engine_for()
    t0 = time.monotonic()  # the scheduler's production clock
    window, cooldown = 1.0, 1.5
    policy = ResiliencePolicy(retry=RetryPolicy(max_attempts=3, backoff_base_s=0.01, seed=SEED),
                              breaker=BreakerConfig(trip_after=2, cooldown_s=cooldown))
    plan = FaultPlan(seed=SEED, rules=(FaultRule(kind="transient", rate=1.0, executor_substr="megakernel", t0=t0,
                                                 t1=t0 + window),))
    sched = engine.scheduler(SchedulerConfig(max_batch_requests=1), resilience=policy, fault_plan=plan)
    check(sched.clock.now() >= t0, "the scheduler's clock is not time.monotonic()")
    pool = [vols[0], vols[3]]
    asked = {engine.submit_async(pool[i % 2], executor="cuda_megakernel"): pool[i % 2] for i in range(6)}
    comps, counts = count_launches(dev, engine.drain)
    states = [tr["state"] for tr in sched.breaker.transitions]
    if "closed" not in states:  # every request served while open: one more after the cooldown probes
        time.sleep(max(0.0, sched.breaker.entries[next(iter(sched.breaker.entries))].opened_s + cooldown
                       - time.monotonic()) + 0.01)
        asked[engine.submit_async(pool[0], executor="cuda_megakernel")] = pool[0]
        more, extra = count_launches(dev, engine.drain)
        comps += more
        counts = summed([counts, extra])
        states = [tr["state"] for tr in sched.breaker.transitions]
    st = sched.stats
    rungs: dict = {}
    for x in comps:
        rungs[x.record.executor] = rungs.get(x.record.executor, 0) + 1
    fails = [r for r in engine.log.records if r.status == "fail"]
    print(f"breaker transitions {sched.breaker.transitions}; served by executor {rungs}; retries {st.retries}, "
          f"transient faults {st.transient_faults}, faulted {st.faulted_requests}, recovered "
          f"{st.recovered_requests}; launches {counts} ({card})")
    check(states == ["open", "half_open", "closed"], f"breaker transitions {states}")
    check(all("injected transient" in r.extra.get("error", "") and r.executor == "cuda_megakernel" for r in fails)
          and len(fails) == st.transient_faults >= 2, f"a fault that was not injected: {[r.extra for r in fails]}")
    check(not cuda or all(r.executor in ("cuda_fused", "cuda_megakernel") for r in engine.log.records),
          f"an attempt ran off the card's ladder: {[r.executor for r in engine.log.records]}")
    check(st.faulted_requests == st.recovered_requests >= 2 and st.retries >= 2 and st.conserved()
          and all(x.record.status == "ok" for x in comps), f"12b: {st}")
    # in the order served: cuda_fused while the breaker is open, then the
    # half-open probe and every later request under cuda_megakernel
    order = [x.record.executor for x in sorted(comps, key=lambda x: x.finish_s)]
    k = order.count("cuda_fused")
    print(f"served in order: {order}")
    check(order == ["cuda_fused"] * k + ["cuda_megakernel"] * (len(order) - k) and 1 <= k < len(order),
          f"served in order {order}")
    expect = summed(implied_launches(x.record, cfg, mcfg, shape, cube, overlap) for x in comps) if cuda else zero
    check(counts == expect, f"12b launched {counts}, the served records imply {expect} (the faults none)")
    check(not cuda or (counts["K1"] > 0 and counts["K2"] > 0), f"12b launched {counts}")
    out["breaker"] = {"launches": counts, "served": rungs}
    plain = {}
    for x in comps:
        vol = asked[x.id]
        key = (id(vol), x.record.executor)
        if key not in plain:
            plain[key] = engine.submit(vol, executor=x.record.executor).segmentation
        agree = float((plain[key] == x.result.segmentation).float().mean())
        check(agree >= ARGMAX_AGREE, f"request {x.id} agrees with submit under {x.record.executor} on {agree:.6%}")
    print(f"each of the {len(comps)} segmentations agrees with submit's under its executor on >= "
          f"{ARGMAX_AGREE:.2%} of voxels ({len(plain)} submits, one per volume and executor)")
    t_12c = time.perf_counter()
    print(f"12b took {t_12c - t_12b:.1f} s, at least the breaker's {cooldown:.1f}-s cooldown of it ({card})")

    print("-- 12c: the conform memo: two submits of one volume under PipelineConfig(conform_memo=ConformMemo())")
    memo = ConformMemo()
    engine = engine_for(dataclasses.replace(pc, conform_memo=memo))
    before = cuda_bytes(dev)
    first = engine.submit(vols[2])
    second = engine.submit(vols[2])
    memo_bytes = sum(t.numel() * t.element_size() for t in memo.entries.values())
    warm = engine_for().submit(vols[2]).record.times.preprocessing
    print(f"memo hits {memo.hits} misses {memo.misses}; preprocessing of the raw {tuple(vols[2].shape)} volume: "
          f"{first.record.times.preprocessing * 1e3:.3f} ms (memo miss: one hash, the conform) then "
          f"{second.record.times.preprocessing * 1e3:.3f} ms (memo hit: hash and lookup); without a memo, after "
          f"both, {warm * 1e3:.3f} ms (conform); the memo holds {memo_bytes} bytes on the {dev.type} "
          f"(memory_allocated +{cuda_bytes(dev) - before} with the two results) ({card})")
    check((memo.hits, memo.misses) == (1, 1) and torch.equal(first.segmentation, second.segmentation),
          "the conform memo did not hit once, or the segmentations differ")
    (held_vol,) = memo.entries.values()
    check(torch.equal(held_vol, conform.conform(torch.as_tensor(vols[2], dtype=torch.float32), shape)),
          "the memoised conformed volume changed in serving")
    out["memo_ms"] = (first.record.times.preprocessing * 1e3, second.record.times.preprocessing * 1e3, warm * 1e3)
    out["memo_bytes"] = memo_bytes
    t_end = time.perf_counter()
    out["seconds"] = t_end - t_phase
    print(f"12c took {t_end - t_12c:.1f} s; phase 12 took {t_end - t_phase:.1f} s, its set-up included ({card})")
    return out


# ------------------------------------------------------ phase 13: the fleet ---


def fleet_engines(dev, size: int, cube: int, overlap: int):
    """Phase 11's served configuration as an engine factory: gwm_light at
    size^3 with brain_mask_fast as the crop model, each engine with its own
    copy of the weights (the mask model's too); its volumes."""
    cfg, mcfg, params, mparams, vols, _ = served_models(dev, size)
    pc = PipelineConfig(name="gwm_light", model=cfg, volume_shape=(size,) * 3, use_cropping=True, cube=cube,
                        overlap=overlap)

    def factory():
        return SegmentationEngine(tree.map(torch.clone, params), pc, mask_model=(tree.map(torch.clone, mparams), mcfg),
                                  device=dev)

    return cfg, mcfg, vols, factory


def phase_fleet(dev, size: int, rehearsal: bool) -> dict:
    t_phase = time.perf_counter()
    cube, overlap = (8, 4) if rehearsal else (CUBE, OVERLAP)
    card = card_line(rehearsal)

    def say(text: str) -> None:
        print(f"{text} ({card})")

    say(f"== phase 13: the replicated fleet (serving/fleet.py) at {size}^3")
    cfg, mcfg, vols, factory = fleet_engines(dev, size, cube, overlap)
    shape = (size,) * 3
    gen = torch.Generator().manual_seed(SEED + 13)
    vols = vols + [mri.generate(gen, mri.SyntheticMRIConfig(shape=shape), device=dev)[0] for _ in range(3)]
    cuda = dev.type == "cuda"
    fused = "cuda_fused" if cuda else "torch"
    standalone = factory()
    plain = {}

    def submit_of(vol, rec):
        """submit's segmentation of ``vol`` on a standalone engine at the
        record's mode, executor and precision (memoised)."""
        key = (id(vol), rec.mode, rec.executor, rec.precision)
        if key not in plain:
            plain[key] = standalone.submit(vol, mode=rec.mode, executor=rec.executor,
                                           precision=rec.precision).segmentation
        return plain[key]

    def implied(recs) -> dict:
        return summed(implied_launches(r, cfg, mcfg, shape, cube, overlap) for r in recs) if cuda else summed([])

    def executed_fleet(**kw):
        return Fleet(FleetConfig(replicas=2, execute=True, scheduler=SchedulerConfig(max_batch_requests=4), **kw),
                     engine_factory=factory)

    out = {}
    t_13a = time.perf_counter()
    say(f"set-up (the served models, {len(vols)} volumes, a standalone engine) took {t_13a - t_phase:.1f} s")

    say("-- 13a: 2 replicas under cache_affinity, executed: wave 1 an fp32 (auto) and a bf16 request, drained; "
        "wave 2 two fp32 (auto), a bf16 and an fp32 under cuda_megakernel, drained")
    fl = executed_fleet(policy="cache_affinity")
    w0 = [r.engine.params["layers"][0]["w"].data_ptr() for r in fl.replicas]
    check(len(set(w0)) == 2 and w0[0] != standalone.params["layers"][0]["w"].data_ptr(),
          "two replicas (or a replica and the standalone engine) share their weights")
    waves = [[(vols[0], None, None), (vols[1], None, "bf16")],
             [(vols[3], None, None), (vols[4], None, None), (vols[5], None, "bf16"), (vols[2], "cuda_megakernel", None)]]
    asked, warm_at_submit, drain_s = {}, {}, []

    def main_path():
        for wave in waves:
            for vol, executor, precision in wave:
                key, _ = fl.replicas[0].sched.peek_signature(vol, executor=executor, precision=precision)
                warm = {r.id for r in fl.replicas if key in r.warm}
                fid = fl.submit(vol, executor=executor, precision=precision)
                asked[fid] = (vol, executor, precision)
                warm_at_submit[fid] = warm
            synchronize(dev)
            t0 = time.perf_counter()
            fl.drain()
            synchronize(dev)
            drain_s.append(time.perf_counter() - t0)

    _, counts = count_launches(dev, main_path)
    stats = [r.sched.stats for r in fl.replicas]
    say(f"drained {len(fl.ledger)} requests in {[round(s * 1e3, 3) for s in drain_s]} ms host clock (a wave each); "
        f"routes {fl.routes}, affinity hits {fl.affinity_hits}, cold compiles {fl.cold_compiles}; per replica "
        f"admitted {[s.admitted for s in stats]}, batches {[s.batches for s in stats]}; launches {counts}")
    check(fl.conserved() and all(s.conserved() for s in stats), "the fleet is not conserved")
    check(all(e.completions_seen == 1 and e.outcome == "completed" for e in fl.ledger),
          f"ledger: {[(e.fid, e.outcome, e.completions_seen) for e in fl.ledger]}")
    pairs = sum(len(r.warm) for r in fl.replicas)
    check(fl.cold_compiles == pairs == 3, f"cold compiles {fl.cold_compiles}, distinct (replica, signature) {pairs}")
    hits = [fid for fid, warm in warm_at_submit.items() if warm]
    check(fl.affinity_hits == len(hits) == 3 and all(fl.ledger[f].replica in warm_at_submit[f] for f in hits),
          f"affinity: {fl.affinity_hits} hits, warm at submit {warm_at_submit}, routed "
          f"{[(e.fid, e.replica) for e in fl.ledger]}")
    recs = []
    by_sig: dict = {}
    for e in fl.ledger:
        vol, executor, precision = asked[e.fid]
        rec = e.completion.record
        want = "cuda_megakernel" if executor == "cuda_megakernel" else fused
        check(rec.status == "ok" and rec.executor == want and rec.precision == (precision or "fp32")
              and rec.replica_id == e.replica, f"fid {e.fid}: {rec.status} {rec.executor} {rec.precision} "
              f"replica {rec.replica_id}/{e.replica} {rec.fail_type} {rec.extra.get('error')}")
        check(torch.equal(e.completion.result.segmentation, submit_of(vol, rec)),
              f"fid {e.fid}'s segmentation differs from submit's")
        recs.append(rec)
        by_sig.setdefault((e.replica, rec.executor, rec.precision), []).append(rec.times.total() * 1e3)
    check(owned([e.completion for e in fl.ledger]), "two completions share a segmentation")
    expect = implied(recs)
    check(counts == expect, f"the fleet launched {counts}, its records imply {expect}")
    check(not cuda or (counts["K1"] > 0 and counts["K1r"] > 0 and counts["K2"] > 0), f"13a launched {counts}")
    for (rid, executor, precision), ms in sorted(by_sig.items()):
        say(f"replica {rid} {executor} {precision}: first request {ms[0]:.3f} ms host clock (pipeline stages), later "
            f"{[round(m, 3) for m in ms[1:]]}; the service model charges cold_compile_s "
            f"{fl.cfg.service.cold_compile_s} s once per (replica, signature)")
    out["main"] = counts
    out["first_use_ms"] = {f"{rid}/{ex}/{pr}": ms for (rid, ex, pr), ms in sorted(by_sig.items())}
    t_13b = time.perf_counter()
    say(f"13a took {t_13b - t_13a:.1f} s")

    say("-- 13b: failover: 4 fp32 requests round-robin on 2 replicas, crash_replica(0) with 2 queued there, drain; "
        "then drain_replica(1) on a fresh fleet and 2 requests")
    fl = executed_fleet(policy="round_robin")
    batch = [vols[i] for i in (0, 3, 4, 5)]
    fids = [fl.submit(v) for v in batch]
    on0 = [e.fid for e in fl.ledger if e.replica == 0]
    check(len(on0) == 2 and len(fl.replicas[0].sched.queue) == 2, f"queued on replica 0: {on0}")

    def crash_then_drain():
        fl.crash_replica(0)
        fl.drain()

    _, counts = count_launches(dev, crash_then_drain)
    recs = [e.completion.record for e in fl.ledger]
    say(f"crash_replica(0): redispatched {fl.redispatched}, evacuated {fl.replicas[0].sched.stats.evacuated}; served "
        f"on {[e.replica for e in fl.ledger]}, dispatches {[e.dispatches for e in fl.ledger]}; launches {counts}")
    check(fl.redispatched == len(on0) and fl.replicas[0].crashed and fl.replicas[0].sched.stats.evacuated == len(on0)
          and fl.replicas[0].sched.stats.completed == 0 and fl.conserved(), f"failover: {fl.replicas[0].sched.stats}")
    for fid, vol in zip(fids, batch):
        e = fl.ledger[fid]
        rec = e.completion.record
        check(e.replica == 1 == rec.replica_id and e.completions_seen == 1 and e.outcome == "completed"
              and e.dispatches == (2 if fid in on0 else 1) and rec.status == "ok" and rec.executor == fused,
              f"fid {fid}: replica {e.replica} dispatches {e.dispatches} {e.outcome} {rec.status}")
        check(torch.equal(e.completion.result.segmentation, submit_of(vol, rec)),
              f"fid {fid}'s segmentation differs from submit's")
    expect = implied(recs)
    check(counts == expect, f"failover launched {counts}, the {len(recs)} served records imply {expect}")
    out["failover"] = counts

    fl = executed_fleet(policy="cache_affinity")
    fl.drain_replica(1)
    pair = [vols[0], vols[3]]
    _, counts = count_launches(dev, lambda: ([fl.submit(v) for v in pair], fl.drain()))
    recs = [e.completion.record for e in fl.ledger]
    say(f"drain_replica(1): served on {[e.replica for e in fl.ledger]}; replica 1 retired {fl.replicas[1].retired}, "
        f"admitted {fl.replicas[1].sched.stats.admitted}; scale events {fl.scale_log}; launches {counts}")
    check(all(e.replica == 0 and e.outcome == "completed" for e in fl.ledger) and fl.replicas[1].retired
          and fl.replicas[1].sched.stats.admitted == 0 and fl.conserved(), "a drained replica took a route")
    check(all(torch.equal(e.completion.result.segmentation, submit_of(v, e.completion.record))
              for e, v in zip(fl.ledger, pair)), "a segmentation after the drain differs from submit's")
    check(counts == implied(recs), f"after the drain launched {counts}, the records imply {implied(recs)}")
    t_13c = time.perf_counter()
    say(f"13b took {t_13c - t_13b:.1f} s")

    horizon = 10.0 if rehearsal else 60.0
    say(f"-- 13c: simulate_fleet(fleet_preset('fleet_steady', horizon_s={horizon:g})) executed on "
        f"reference_engine replicas, beside the same configuration modeled on this host")

    def ref_engine():
        return simulator.reference_engine(device=dev)

    cfg_x = fleet_preset("fleet_steady", horizon_s=horizon)
    cfg_x.execute = True
    t0 = time.perf_counter()
    rep, counts = count_launches(dev, lambda: simulate_fleet(cfg_x, ref_engine))
    wall = time.perf_counter() - t0
    modeled = simulate_fleet(fleet_preset("fleet_steady", horizon_s=horizon), ref_engine)
    s = rep.summary()
    say(f"fleet_steady executed: {rep.arrived} arrivals, {s['requests']}, batches {s['batches']}, affinity "
        f"{s['affinity']}, in {wall:.3f} s wall; virtual latency ms {s['latency_ms']}; launches {counts}")
    check(rep.fleet.conserved(), "the executed fleet_steady is not conserved")
    card_execs = ("cuda_fused", "cuda_megakernel") if cuda else ("torch",)
    garbage = 0
    for e in rep.fleet.ledger:
        rec = e.completion.record
        if rec.mode == "none":
            garbage += 1
            check(rec.status == "fail" and rec.fail_type == "permanent_fault", f"garbage fid {e.fid}: {rec.fail_type}")
        else:
            check(rec.status == "ok" and rec.executor in card_execs,
                  f"fid {e.fid}: {rec.status} {rec.executor} {rec.fail_type} {rec.extra.get('error')}")
    dec_x = [(e.fid, e.replica, e.dispatches, e.outcome) for e in rep.fleet.ledger]
    dec_m = [(e.fid, e.replica, e.dispatches, e.outcome) for e in modeled.fleet.ledger]
    differ = [(a, b) for a, b in zip(dec_x, dec_m) if a != b]
    same_finish = [e.finish_s for e in rep.fleet.ledger] == [e.finish_s for e in modeled.fleet.ledger]
    say(f"executed against modeled: {len(dec_x)} and {len(dec_m)} fids, {len(differ)} differ in (replica, "
        f"dispatches, outcome), 0 exempt; first differing {differ[0] if differ else None}; finish times equal "
        f"{same_finish}; {garbage} garbage requests failed typed")
    check(len(dec_x) == len(dec_m) and not differ, f"the executed fleet decided otherwise than the modeled one: "
          f"first differing (executed, modeled) {differ[0] if differ else None}")
    check(garbage > 0 or rehearsal, "the trace had no garbage request")
    check(not cuda or (counts["K1"] > 0 and counts["K1r"] > 0), f"13c launched {counts}")
    out["simulate"] = counts
    out["simulate_s"] = wall
    t_13d = time.perf_counter()
    say(f"13c took {t_13d - t_13c:.1f} s")

    say("-- 13d: the shared tier: FleetConfig(cache=CacheConfig()), round_robin: a volume served on replica 0, its "
        "byte-equal twin routed to replica 1")
    fl = executed_fleet(policy="round_robin", cache=CacheConfig())
    first, c_first = count_launches(dev, lambda: (fl.submit(vols[0].clone()), fl.drain())[0])
    twin, c_twin = count_launches(dev, lambda: (fl.submit(vols[0].clone()), fl.drain())[0])
    a, b = fl.ledger[first], fl.ledger[twin]
    block = fl.cache.summary()
    say(f"first: replica {a.replica} cache_hit {a.completion.record.cache_hit} launches {c_first}; twin: replica "
        f"{b.replica} outcome {b.outcome} cache_hit {b.completion.record.cache_hit} launches {c_twin}; cache {block}")
    check(a.replica == 0 and b.replica == 1 and b.outcome == "completed" and b.completion.record.cache_hit
          and not a.completion.record.cache_hit and fl.replicas[1].sched.stats.cache_hits == 1,
          "the twin was not an admission hit on the other replica")
    check(c_first == implied([a.completion.record]) and c_twin == summed([]),
          f"the first launched {c_first}, the twin {c_twin}")
    check(torch.equal(b.completion.result.segmentation, a.completion.result.segmentation)
          and torch.equal(a.completion.result.segmentation, submit_of(vols[0], a.completion.record)),
          "the twin's segmentation differs")
    entries = [e.result.segmentation for e in fl.cache.entries.values() if e.result is not None]
    ptrs = [a.completion.result.segmentation.data_ptr(), b.completion.result.segmentation.data_ptr()]
    check(owned([a.completion, b.completion]) and not set(ptrs) & {t.data_ptr() for t in entries},
          "two completions, or a completion and the cache, share a segmentation")
    check(fl.cache.stats.quarantined_served == 0 and fl.conserved(), "13d")
    out["hit"] = c_twin
    t_end = time.perf_counter()
    out["seconds"] = t_end - t_phase
    say(f"13d took {t_end - t_13d:.1f} s; phase 13 took {t_end - t_phase:.1f} s, its set-up included")
    return out


# --------------------------------------------------- phase 14: the U-Net ---


def phase_unet3d(dev, size: int, rehearsal: bool) -> dict:
    t_phase = time.perf_counter()
    card = card_line(rehearsal)

    def say(text: str) -> None:
        print(f"{text} ({card})")

    ucfg = unet3d.UNet3DConfig(base_channels=8, levels=2)
    small = 16 if rehearsal else 64
    say(f"== phase 14: the U-Net baseline (core/unet3d.py), {ucfg}, {ucfg.param_count()} parameters")
    gen = torch.Generator().manual_seed(SEED + 14)
    params_cpu = unet3d.init(ucfg, generator=gen, device="cpu")
    params = tree.map(lambda t: t.to(dev), params_cpu)
    x = torch.rand((1, small, small, small), generator=gen)
    expect = unet3d.apply(params_cpu, x, ucfg)
    got = unet3d.apply(params, x.to(dev), ucfg).cpu()
    abs_err, rel = rel_err(got, expect)
    agree = float((got.argmax(-1) == expect.argmax(-1)).float().mean())
    say(f"at {small}^3 on the {dev.type} against the CPU forward on the same weights (TF32 off): logits max_abs_err "
        f"{abs_err:.3e}, {rel:.3e} of the largest; argmax agrees on {agree:.6%}")
    check(rel <= MEGA_FORWARD_REL_TOL and agree >= ARGMAX_AGREE, f"the U-Net on the {dev.type}: rel {rel}, argmax {agree}")
    out = {"rel_err": rel}
    if not rehearsal:
        xs = torch.rand((1,) + (size,) * 3, generator=gen).to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        u_ms = time_ms(lambda: unet3d.apply(params, xs, ucfg), runs=10, warmup=2)
        peak = torch.cuda.max_memory_allocated(dev)
        cfg = meshnet.PAPER_MODELS["gwm_light"]
        gparams = with_bn_stats(meshnet.init(cfg, generator=gen, device=dev), gen)
        g_ms = time_ms(lambda: ops.meshnet_apply(gparams, xs, cfg), runs=10, warmup=2)
        say(f"times forward unet3d at {size}^3: {u_ms:.4f} ms (CUDA-event median of 10; F.conv3d, max_pool3d, "
            f"conv_transpose3d in fp32, TF32 off; peak memory {peak / 2**30:.2f} GiB); gwm_light cuda_fused "
            f"{g_ms:.4f} ms; parameters {ucfg.param_count()} against {cfg.param_count()}")
        out.update(unet3d_ms=u_ms, gwm_light_ms=g_ms, peak_bytes=peak)
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase 14 took {out['seconds']:.1f} s")
    return out


def kernels_line(rows, seg_rows, launches: dict, k1_err, k2_err, k3_row, k3_err, k4_err, k4_row, views,
                 k1r_rows, k1r_err, k2r_rows, k2r_err, k2z_rows, k2z_err) -> dict:
    """Per-forward numbers of K1, K2 and K5: one gwm_light forward at 256^3,
    9 launches of K1 or K5 or one launch of K2 per segment of the plan; K3's
    per count of one 256^3 3-class pair; K4's per launch at the served
    shape."""

    def totals(rs, per=lambda r: 1):
        t = {k: sum(r[k] * per(r) for r in rs) for k in ("kernel_ms", "plain_ms")}
        t_ops = sum(r["bound_ms"] * per(r) for r in rs if r["bound_by"] == "operations")
        t_bytes = sum(r["bound_ms"] * per(r) for r in rs if r["bound_by"] == "bytes")
        return t, t_ops + t_bytes, "operations" if t_ops >= t_bytes else "bytes"

    t1, b1, by1 = totals(rows, lambda r: r["launches_per_forward"])
    t2, b2, by2 = totals(seg_rows)
    per_layer = lambda r: r["launches_per_forward"]  # noqa: E731
    r16 = [r for r in k1r_rows if r["weights"] == "bf16"]
    r8 = [r for r in k1r_rows if r["weights"] == "int8"]
    t16, b16, by16 = totals(r16, per_layer)
    t8, b8, _ = totals(r8, per_layer)
    s16 = [r for r in k2r_rows if r["precision"] == "bf16"]
    s8 = [r for r in k2r_rows if r["precision"] == "int8w"]
    tk16, bk16, byk16 = totals(s16)
    tk8, bk8, _ = totals(s8)
    z = {p: totals([r for r in k2z_rows if r["precision"] == p]) for p in ("fp32", "bf16", "int8w")}
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
                "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in rows),
                "library": "F.conv3d (cuDNN, fp32, TF32 off) over the same 9 one-layer segments' layers (phase 6), "
                           "conv + bias only",
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
            {
                "name": "decode_attention",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:33",
                "tpu_kernel": "src/repro/kernels/decode_attention.py::_decode_attn_kernel",
                "launches": launches["lm"]["K4"],
                "max_abs_err": k4_err["fp32"],
                "max_abs_err_bf16": k4_err["bf16"],
                "ms": k4_row["kernel_ms"],
                "plain_ms": k4_row["plain_ms"],
                "bound_ms": k4_row["bound_ms"],
                "bound_by": k4_row["bound_by"],
                "library_ms": k4_row["library_ms"],
                "library": "F.scaled_dot_product_attention(enable_gqa=True) with the same boolean mask",
                "call_ms": k4_row["call_ms_cuda_events"]["kernel"],
                "ms_pos_on_card": k4_row["kernel_pos_on_card_ms"],
                "ms_full_cache": k4_row["full_cache"]["kernel_ms"],
                "plain_ms_full_cache": k4_row["full_cache"]["plain_ms"],
                "bound_ms_full_cache": k4_row["full_cache"]["bound_ms"],
                "library_ms_full_cache": k4_row["full_cache"]["library_ms"],
                "per": f"one call at the served shape (B {k4_row['B']}, H {k4_row['H']}, KV {k4_row['KV']}, "
                       f"hd {k4_row['hd']}, S {k4_row['S']}, pos {k4_row['pos']}, fp32; *_full_cache at pos "
                       f"{k4_row['full_cache']['pos']}); one launch of {k4_row['blocks']} blocks; ms, plain_ms and "
                       "library_ms are device times per call with a cold L2 (chip_smoke.cold_ms), pos a host int "
                       "(ms_pos_on_card: a (1,) int32 on the card), call_ms the CUDA-event "
                       "median of back-to-back calls, the host's time included; launches from "
                       f"LMEngine serving {LM_REQUESTS} requests at {LM_ARCH} full width (22 a decode step, pos on "
                       "the card)",
            },
            {
                "name": "dilated_conv3d_views",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dilated_conv3d_views.cu",
                "replaces": "src/repro/kernels/dilated_conv3d.py:114",
                "tpu_kernel": "src/repro/kernels/dilated_conv3d.py::_views_kernel",
                "launches": views["launches"],
                "max_abs_err": views["err"][0],
                "max_rel_err": views["err"][1],
                "ms": sum(r["views_ms"] * r["launches_per_forward"] for r in views["rows"]),
                "k1_ms_same_call": sum(r["halo_ms"] * r["launches_per_forward"] for r in views["rows"]),
                "plain_ms": t1["plain_ms"],
                "bound_ms": b1,
                "bound_by": by1,
                "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in rows),
                "per": "one gwm_light forward at 256^3 (9 launches; K1's function, so K1's plain, bound and "
                       "F.conv3d times); launches from K5's path as K1's oracle over one served forward, "
                       "bit-equal to K1 at every layer",
            },
            {
                "name": "dilated_conv3d_lp",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/dilated_conv3d_lp.cu",
                "replaces": "src/repro/kernels/dilated_conv3d.py:62",
                "tpu_kernel": "src/repro/kernels/dilated_conv3d.py::_halo_kernel (bf16 and int8w policies)",
                "launches": launches["subvolume"]["reduced"]["K1r"],
                "max_abs_err": k1r_err,
                "ms": t16["kernel_ms"],
                "device_ms": sum(r["device_ms"] * r["launches_per_forward"] for r in r16),
                "plain_ms": t16["plain_ms"],
                "bound_ms": b16,
                "bound_by": by16,
                "library_ms": sum(r["library_ms"] * r["launches_per_forward"] for r in r16),
                "library": "F.conv3d on bf16 operands (cuDNN), conv + bias only",
                "registers": max(r["registers"] for r in k1r_rows),
                "blocks_per_sm": sorted({r["blocks_per_sm"] for r in k1r_rows}),
                "fp32_cuda_core_ms": sum(r["fp32_cuda_core_ms"] * r["launches_per_forward"] for r in r16),
                "ms_int8w": t8["kernel_ms"],
                "plain_ms_int8w": t8["plain_ms"],
                "bound_ms_int8w": b8,
                "per": "one gwm_light forward at 256^3 at bf16 (9 launches; *_int8w the same with int8 weights); "
                       "bound: operations over the bf16 tensor-core peak or bytes at 2 B an activation over the "
                       "memory rate; launches from one bf16 and one int8w request served under auto (18 each)",
            },
            {
                "name": "megakernel_segment_lp",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/megakernel_lp.cu",
                "replaces": "src/repro/kernels/megakernel.py:482",
                "tpu_kernel": "src/repro/kernels/megakernel.py::_segment_kernel (bf16 and int8w policies: "
                              "deq_in, quant_out, compute-dtype scratch)",
                "launches": launches["subvolume"]["reduced"]["K2r"],
                "max_abs_err": k2r_err,
                "ms": tk16["kernel_ms"],
                "plain_ms": tk16["plain_ms"],
                "bound_ms": bk16,
                "bound_by": byk16,
                "library_ms": sum(r["library_ms"] for r in s16),
                "library": "F.conv3d (cuDNN) on bf16 operands over the same segments' layers (phase 9d), conv only",
                "device_ms": sum(r["device_ms"] for r in s16),
                "modeled_ms": sum(r["modeled_ms"] for r in s16),
                "plan_bound_ms": sum(r["plan_bound_ms"] for r in s16),
                "fp32_cuda_core_ms": sum(r["fp32_cuda_core_ms"] for r in s16),
                "ms_int8w": tk8["kernel_ms"],
                "plain_ms_int8w": tk8["plain_ms"],
                "bound_ms_int8w": bk8,
                "library_ms_int8w": sum(r["library_ms"] for r in s8),
                "per": f"one gwm_light forward at 256^3 at bf16 ({len(s16)} launches, one a segment; *_int8w the "
                       "same at int8w, int8 staging); ms: the launches' CUDA-event medians (chip_smoke.time_ms, as "
                       "every row's), device_ms their device time (10 back to back); bound: the function's "
                       "operations "
                       "over the bf16 tensor-core peak or its bytes at the policy's widths over the memory rate; "
                       "max_abs_err the worst bf16 gap to the plain version in phase 9e (int8 codes within 1); "
                       "launches from one bf16 and one int8w request served under cuda_megakernel",
            },
            {
                "name": "megakernel_segment_z",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/megakernel.cu",
                "sources": ["src/repro_torch/kernels/csrc/megakernel.cu", "src/repro_torch/kernels/csrc/megakernel_lp.cu"],
                "replaces": "src/repro/kernels/megakernel.py:482",
                "tpu_kernel": "src/repro/kernels/megakernel.py::_segment_kernel(has_z_bounds=True) (:488, :531, "
                              ":570-583): K2 and K2r with a valid Z interval narrower than the volume",
                "launches": launches["sharded"]["K2z"],
                "max_abs_err": k2z_err["fp32"],
                "max_abs_err_bf16": k2z_err["bf16"],
                "ms": z["fp32"][0]["kernel_ms"],
                "plain_ms": z["fp32"][0]["plain_ms"],
                "bound_ms": z["fp32"][1],
                "bound_by": z["fp32"][2],
                "library_ms": sum(r["library_ms"] for r in k2z_rows if r["precision"] == "fp32"),
                "library": "F.conv3d (cuDNN; fp32 with TF32 off, bf16 at the reduced policies) over the same "
                           "window segments' layers on the rows each band needs (phase 10c)",
                "bound_zbounds_ms": sum(r["bound_zbounds_ms"] for r in k2z_rows if r["precision"] == "fp32"),
                "device_ms": sum(r["device_ms"] for r in k2z_rows if r["precision"] == "fp32"),
                "ms_bf16": z["bf16"][0]["kernel_ms"],
                "plain_ms_bf16": z["bf16"][0]["plain_ms"],
                "bound_ms_bf16": z["bf16"][1],
                "ms_int8w": z["int8w"][0]["kernel_ms"],
                "plain_ms_int8w": z["int8w"][0]["plain_ms"],
                "bound_ms_int8w": z["int8w"][1],
                "library_ms_bf16": sum(r["library_ms"] for r in k2z_rows if r["precision"] == "bf16"),
                "per": f"one sharded_cuda_megakernel@{SLABS} forward of gwm_light at 256^3 at fp32 (*_bf16, *_int8w: "
                       f"K2r-z at those policies): {SLABS} windows of {256 // SLABS} + 2 x 46 rows, one launch a "
                       "segment of each window's plan, each on the band of rows its slab's kept rows need; ms: the "
                       "launches' CUDA-event medians (chip_smoke.time_ms, as every row's), device_ms their device "
                       "time (10 back to back); bound: the work of each segment's band (k2z_work: its taps, each input read once, "
                       "each output written once; bound_zbounds_ms over all the rows inside z_bounds instead) at "
                       "the fp32 CUDA-core peak, "
                       "the reduced policies' at the bf16 tensor-core peak; launches from the fp32, bf16 and int8w "
                       "sharded forwards of phase 10b; max_abs_err the worst fp32 gap to the plain version in phase "
                       "10a (int8 codes within 1)",
            },
        ]
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true", help="tiny shapes, plain paths, CPU; never prints ok")
    parser.add_argument("--k4-kernels", action="store_true",
                        help="only print the kernels of one K4 call under torch.profiler, as JSON (phase 8a runs it)")
    args = parser.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.k4_kernels:
        print(json.dumps(k4_kernels_a_call()))
        return 0
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
        phase_lm(dev, card, rehearsal)
        phase_reduced_forward(dev, size)
        phase_reduced_megakernel(dev, size)
        phase_subvolume(dev, size, rehearsal)
        phase_sharded_parity(dev, size)
        phase_sharded(dev, size, rehearsal)
        phase_queued(dev, size, rehearsal)
        phase_resilience(dev, size, rehearsal)
        phase_fleet(dev, size, rehearsal)
        phase_unet3d(dev, size, rehearsal)
        print(f"cpu rehearsal done in {time.perf_counter() - t_start:.1f} s (no ok line)")
        return 0
    rows, seg_rows = phase_times(dev, card, size)
    k3_cases, k3_err = phase_train_parity_k3(dev)
    phase_train_step_parity(dev, 64)
    trained = phase_train(dev, size)
    launches["train"] = trained["counts"]
    check(launches["train"]["K3"] > 0, "K3 was not launched on its main path")
    k3_row = phase_train_times(dev, card, size, trained)
    k4_err = phase_parity_k4(dev)
    views = phase_views(dev, size, rows)
    lm = phase_lm(dev, card, rehearsal)
    launches["lm"] = lm["counts"]
    check(launches["lm"]["K4"] > 0, "K4 was not launched on its main path")
    check(views["launches"] > 0, "K5 was not launched on its path")
    k1r_err = phase_reduced_parity(dev)
    phase_reduced_forward(dev, size)
    k2r_err = phase_reduced_megakernel(dev, size)
    launches["subvolume"] = phase_subvolume(dev, size, rehearsal)
    check(launches["subvolume"]["reduced"]["K1r"] > 0, "K1r was not launched on its main path")
    check(launches["subvolume"]["reduced"]["K2r"] > 0, "K2r was not launched on its main path")
    k1r_rows, k2r_rows = phase_reduced_times(dev, card, size)
    k2z_err = phase_sharded_parity(dev, size)
    launches["sharded"] = phase_sharded(dev, size, rehearsal)
    check(launches["sharded"]["K2z"] > 0, "K2z was not launched on its main path")
    k2z_rows = phase_sharded_times(dev, card, size)
    launches["queued"] = phase_queued(dev, size, rehearsal)
    for k in ("K1", "K1r", "K2"):
        check(launches["queued"]["drain"][k] > 0, f"{k} was not launched on the queued path")
    launches["resilience"] = phase_resilience(dev, size, rehearsal)
    launches["fleet"] = phase_fleet(dev, size, rehearsal)
    for k in ("K1", "K1r", "K2"):
        check(launches["fleet"]["main"][k] > 0, f"{k} was not launched on the fleet's path")
    phase_unet3d(dev, size, rehearsal)
    print(json.dumps(kernels_line(rows, seg_rows, launches, k1_err, k2_err, k3_row, k3_err, k4_err, lm["k4_row"], views,
                                  k1r_rows, k1r_err, k2r_rows, k2r_err, k2z_rows, k2z_err)))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
