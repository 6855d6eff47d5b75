"""Serving engines — counterpart of ``repro/serving/engine.py``.

LMEngine — continuous-batching text generation for a ModelConfig of the
dense family: chunked prefill through ``decode_step``, slots at one
position stepped in lock-step, greedy or temperature sampling, per-slot
EOS / ``max_new_tokens`` / ``max_seq`` retirement and slot reuse. Every
attention layer of every step is one launch of K4 on the card.

SegmentationEngine — picks full-volume streaming vs the sub-volume
failsafe per request from the memory budget (one H100's device memory by
default), at the request's precision policy, runs the pipeline on the
engine's device with the weights prepared once per policy, and logs each
request's telemetry. ``submit`` serves one volume synchronously; the
queued entry points — ``submit_async`` and ``drain``, and
``submit_many``'s dispatch — go through the continuous-batching request
scheduler (serving/scheduler.py): a bounded queue with typed
``QueueFullError`` backpressure, priority and deadline classes,
budget-priced admission with shed-to-subvolume demotion, and grouping of
requests that share a resolved signature; given a resilience policy, a
fault plan or an artifact cache at creation, it retries, walks the
breaker's ladder and answers repeated volumes from the cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device, synchronize, tree
from repro_torch.core import pipeline as pl
from repro_torch.core import spatial_shard
from repro_torch.kernels import quantize
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.serving.scheduler import DEFAULT_CLASSES, PriorityClass, RequestScheduler, SchedulerConfig
from repro_torch.telemetry.budget import BudgetExceeded, MemoryBudget
from repro_torch.telemetry.record import TelemetryLog


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    id: int = 0


@dataclasses.dataclass
class Completion:
    id: int
    tokens: list[int]
    prefill_s: float
    decode_s: float


class LMEngine:
    """Static-slot continuous batching engine on one device
    (``device=None``: the CUDA card, which must exist; ``params`` already
    on it).

    ``slots`` concurrent sequences share one cache; finished slots are
    refilled from the queue. A request's prompt (all but its last token)
    is prefilled token by token through ``decode_step`` on the slot's lane
    of the cache, its token ids sent to the device ``prefill_chunk`` at a
    time. Decode advances the live slots that share a position with one
    ``decode_step`` over every slot; the step writes its K/V column at
    that position for every lane, and the lanes of the slots not stepped
    get their column back (the reference's masked merge, on the one column
    a step writes). ``steps`` counts ``decode_step`` calls, prefill's
    included. Temperature sampling draws from ``generator`` (a CPU
    ``torch.Generator``; seed 0 by default).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        slots: int = 4,
        max_seq: int = 512,
        prefill_chunk: int = 64,
        eos_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        MD.check_supported(cfg)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.prefill_chunk = prefill_chunk
        self.eos_id = eos_id
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cache = MD.init_cache(cfg, slots, max_seq, device=self.device)
        self.pos = np.zeros((slots,), np.int64)  # per-slot next position
        self.live = np.zeros((slots,), bool)
        self.steps = 0

    def _step(self, tokens: torch.Tensor, cache, pos: int) -> torch.Tensor:
        """One ``decode_step`` -> the last position's logits (B, V)."""
        self.steps += 1
        logits, _ = MD.decode_step(self.params, tokens, cache, pos, self.cfg)
        return logits[:, -1]

    # --- prefill ------------------------------------------------------------

    def _prefill_one(self, slot: int, prompt: list[int]) -> None:
        """Feed a prompt token by token through decode_step on the slot's
        lane of the cache (views, so the engine's cache fills in place)."""
        one = tree.map(lambda c: c[:, slot : slot + 1], self.cache)
        pos = int(self.pos[slot])
        for i in range(0, len(prompt), self.prefill_chunk):
            part = torch.tensor(prompt[i : i + self.prefill_chunk], dtype=torch.int64, device=self.device)
            for j in range(part.shape[0]):
                self._step(part[j : j + 1, None], one, pos)
                pos += 1
        self.pos[slot] = pos

    # --- main loop ------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return int(torch.multinomial(probs, 1, generator=self.generator))
        return int(torch.argmax(logits))

    def run(self, requests: list[Request]) -> list[Completion]:
        queue = list(requests)
        active: dict[int, dict] = {}
        done: list[Completion] = []

        def admit():
            for s in range(self.slots):
                if not self.live[s] and queue:
                    req = queue.pop(0)
                    t0 = time.perf_counter()
                    self.pos[s] = 0
                    self._reset_slot(s)
                    self._prefill_one(s, req.prompt[:-1])
                    synchronize(self.device)
                    active[s] = {
                        "req": req,
                        "out": [],
                        "next": req.prompt[-1],
                        "prefill_s": time.perf_counter() - t0,
                        "t0": time.perf_counter(),
                    }
                    self.live[s] = True

        admit()
        while active:
            tokens = np.zeros((self.slots, 1), np.int64)
            for s, st in active.items():
                tokens[s, 0] = st["next"]
            tokens = torch.from_numpy(tokens).to(self.device)
            # Slots at one position step together; decode_step takes one
            # position, so slots whose positions differ step in turns.
            groups: dict[int, list[int]] = {}
            for s in active:
                groups.setdefault(int(self.pos[s]), []).append(s)
            for pos, slot_ids in groups.items():
                stepped = torch.zeros((self.slots,), dtype=torch.bool)
                stepped[slot_ids] = True
                stepped = stepped.to(self.device)
                col = pos % self.cache[0]["k"].shape[2]
                kept = tree.map(lambda c: c[:, :, col].clone(), self.cache)
                lg = self._step(tokens, self.cache, pos).float().cpu()

                def merge(c, old):
                    c[:, :, col] = torch.where(stepped.view(1, -1, 1, 1), c[:, :, col], old)

                tree.map(merge, self.cache, kept)
                for s in slot_ids:
                    st = active[s]
                    nxt = self._sample(lg[s], st["req"].temperature)
                    st["out"].append(nxt)
                    st["next"] = nxt
                    self.pos[s] += 1
                    if (
                        len(st["out"]) >= st["req"].max_new_tokens
                        or (self.eos_id is not None and nxt == self.eos_id)
                        or self.pos[s] >= self.max_seq - 1
                    ):
                        done.append(
                            Completion(
                                id=st["req"].id,
                                tokens=st["out"],
                                prefill_s=st["prefill_s"],
                                decode_s=time.perf_counter() - st["t0"],
                            )
                        )
                        self.live[s] = False
                        del active[s]
            admit()
        return sorted(done, key=lambda c: c.id)

    def _reset_slot(self, s: int) -> None:
        tree.map(lambda c: c[:, s].zero_(), self.cache)


class SegmentationEngine:
    """Server-side Brainchop on one device (``device=None``: the CUDA card,
    which must exist). ``params`` and the mask model's params must already
    be on that device. ``precision`` is the engine's default storage policy
    ("auto" resolves to fp32 in the port); a request may name another.

    ``devices`` is the engine's default Z-slab count for the sharded
    executors (core/spatial_shard.py; ``PipelineConfig.shard_devices`` when
    not given): each request's inference runs on the first ``devices`` of
    the host's devices of the engine's kind, checked once here
    (``ShardGeometryError`` when the host has fewer). A request may name
    another count (``submit(devices=...)``; 1 runs it on one device)."""

    def __init__(
        self,
        params,
        pipeline_cfg: pl.PipelineConfig,
        *,
        mask_model=None,
        budget: Optional[MemoryBudget] = None,
        devices: Optional[int] = None,
        precision: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = pipeline_cfg
        self.mask_model = mask_model
        self.budget = budget or MemoryBudget.h100()
        self.devices = devices or pipeline_cfg.shard_devices
        self.precision = precision or pipeline_cfg.precision
        self._prepared: dict[str, object] = {}
        if self.devices and self.devices > 1:
            spatial_shard.mesh_for(self.devices, self.device.type)
        self.log = TelemetryLog()
        self._scheduler: Optional[RequestScheduler] = None  # created on first use

    def _params_for(self, precision: str):
        """The weight tree in ``precision`` storage, prepared once per
        policy (``quantize.prepare_params``) and cached for every later
        request, so an int8w request reads the same int8 weights instead
        of quantizing them again."""
        resolved = quantize.resolve_precision(precision, self.cfg.model)
        if resolved not in self._prepared:
            self._prepared[resolved] = quantize.prepare_params(self.params, self.cfg.model, resolved)
        return self._prepared[resolved]

    def pick_mode(self, volume_shape, precision: Optional[str] = None) -> str:
        """Budget-driven failsafe selection at the request's precision:
        "streaming" when two live activations fit, else "subvolume"."""
        resolved = quantize.resolve_precision(precision or self.precision, self.cfg.model)
        try:
            self.budget.charge_streaming(
                volume_shape, self.cfg.model, dtype_bytes=quantize.act_bytes(resolved)
            )
            return "streaming"
        except BudgetExceeded:
            return "subvolume"

    def submit(
        self,
        vol,
        *,
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        devices: Optional[int] = None,
        precision: Optional[str] = None,
    ) -> pl.PipelineResult:
        """Run one volume synchronously; the keyword arguments override the
        engine's defaults for this request only (``devices=None`` keeps the
        engine's slab count, ``devices=1`` runs on one device)."""
        return self._run_request(vol, mode=mode, executor=executor, devices=devices, precision=precision)

    def _run_request(
        self,
        vol,
        *,
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        devices: Optional[int] = None,
        precision: Optional[str] = None,
        volume_shape: Optional[tuple] = None,
    ) -> pl.PipelineResult:
        """The serve path behind ``submit`` and the scheduler: resolve the
        request's defaults, run the pipeline, log telemetry (the scheduler
        calls it per batch member, so its fault isolation wraps exactly
        one request). ``volume_shape`` overrides the engine's conform
        target for this request — the scheduler's ``native_shapes`` mode
        serves each request at the geometry admission priced; ``None``
        keeps the engine's."""
        prec = precision or self.precision
        shape = tuple(volume_shape) if volume_shape else self.cfg.volume_shape
        mode = mode or self.pick_mode(shape, prec)
        cfg = dataclasses.replace(
            self.cfg,
            volume_shape=shape,
            mode=mode,
            budget=self.budget,
            executor=executor or self.cfg.executor,
            shard_devices=devices if devices is not None else self.devices,
            precision=prec,
        )
        res = pl.run(
            cfg, self._params_for(prec), vol, mask_model=self.mask_model, device=self.device
        )
        self.log.append(res.record)
        return res

    # ---- queued serving (serving/scheduler.py) --------------------------

    def scheduler(self, scheduler_cfg=None, **kwargs):
        """The engine's request scheduler, created on first use (pass
        ``scheduler_cfg`` or keyword arguments then — ``clock``,
        ``resilience``, ``fault_plan``, ``cache`` and the rest of
        ``RequestScheduler``'s, passed through). ``submit_async`` and
        ``drain`` go through it. Raises if a configuration is passed after
        it exists: returning the old one would leave the caller believing
        their admission limits are active."""
        if self._scheduler is None:
            self._scheduler = RequestScheduler(self, scheduler_cfg, **kwargs)
        elif scheduler_cfg is not None or kwargs:
            raise ValueError(
                "engine.scheduler() was already created (a prior "
                "submit_async/scheduler call); configuration must be "
                "passed on first use"
            )
        return self._scheduler

    def submit_async(
        self,
        vol,
        *,
        priority: str = "standard",
        mode: Optional[str] = None,
        executor: Optional[str] = None,
        devices: Optional[int] = None,
        precision: Optional[str] = None,
    ) -> int:
        """Enqueue one request with the scheduler and return its id;
        nothing runs until ``drain``. Raises ``QueueFullError`` when the
        queue is at its depth limit."""
        return self.scheduler().submit(
            vol, priority=priority, mode=mode, executor=executor, devices=devices, precision=precision
        )

    def drain(self) -> list:
        """Serve every queued request (grouping, budget admission, priority
        order) and return the new ``Completion``s in id order, each with
        its outcome (completed | demoted | rejected), its stamped record
        and its pipeline result."""
        return self.scheduler().drain()

    def submit_many(
        self,
        vols: list,
        *,
        modes: Optional[list] = None,
        executors: Optional[list] = None,
        devices: Optional[list] = None,
        precisions: Optional[list] = None,
    ) -> list[pl.PipelineResult]:
        """Serve several volumes with a per-request mode, executor, device
        count and precision (``None`` entries keep the engine's defaults),
        and return their results in submission order.

        Dispatch goes through a scheduler of its own with deadline-free
        classes, an unbounded queue, no admission budget and no demotion,
        so every request runs, as a loop of ``submit`` would: requests
        sharing a resolved signature are served back to back as one group,
        the signature resolved and priced once per unique combination. A
        request that raises (a garbage volume, a kernel that fails) gives
        a result with ``segmentation=None`` and a record typed by
        serving/errors.py while the rest complete. Each record carries
        the scheduler's stamps and its submission index in
        ``extra["request_index"]``."""
        n = len(vols)
        for name, given in (("modes", modes), ("executors", executors), ("devices", devices),
                            ("precisions", precisions)):
            if given is not None and len(given) != n:
                raise ValueError(f"{name} must match len(vols): {len(given)} != {n}")
        modes = modes if modes is not None else [None] * n
        execs = executors if executors is not None else [None] * n
        devs = devices if devices is not None else [None] * n
        precs = precisions if precisions is not None else [None] * n
        sched = RequestScheduler(
            self,
            SchedulerConfig(
                max_queue_depth=None,
                admission_hbm_bytes=None,
                max_batch_requests=max(n, 1),
                allow_demotion=False,
                classes={
                    name: PriorityClass(name, c.priority, deadline_s=None) for name, c in DEFAULT_CLASSES.items()
                },
            ),
        )
        for i, vol in enumerate(vols):
            sched.submit(vol, mode=modes[i], executor=execs[i], devices=devs[i], precision=precs[i])
        results = []
        for i, comp in enumerate(sched.drain()):
            res = comp.result
            if res is None:  # a typed failure the scheduler synthesized
                res = pl.PipelineResult(segmentation=None, record=comp.record)
            res.record.extra["request_index"] = i
            results.append(res)
        return results
