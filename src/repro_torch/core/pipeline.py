"""The Brainchop pipeline in PyTorch — counterpart of ``repro/core/pipeline.py``.

conform -> [brain-mask -> crop] -> inference (full | subvolume |
streaming) -> argmax -> connected-components filtering -> uncrop, on one
device, the inference on several under the sharded executors.

Inference dispatches through the executor registry (core/executors.py):
``"auto"`` is ``cuda_fused`` (one fused kernel launch per layer) on the
card and ``torch`` (the plain forward) on the CPU; ``cuda_megakernel``
runs the depth-first forward, ``streaming`` the layer loop. Mode
``subvolume`` (the paper's failsafe) runs the executor on overlapping
cubes (core/patching.py). The conformed volume leaves preprocessing at
the precision policy's storage type (int8 under int8w, bf16 under bf16),
and the mask forward and the crop run on it. The executor and precision
that ran, the weights' bytes and the schedule's modeled device-memory
bytes are stamped on the telemetry record, and each stage is timed into
it; on the card every stage ends in a synchronisation so the times cover
the work, not its launch.

``shard_devices=n`` re-wraps the resolved executor as
``sharded_<inner>@n`` (core/spatial_shard.py: Z-slabs on the first ``n``
of the host's devices of the run's kind), ``1`` unwraps a sharded name,
and ``streaming``, which has no sharded form, stays on one device; the
modeled halo bytes between devices are stamped on
``collective_bytes_modeled``. ``run`` never raises on a budget, plan,
slab-geometry or degenerate-volume failure: it returns a failed record
(``shard_geometry`` where the depth does not divide or the devices are
lacking).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional

import torch

from repro_torch import resolve_device, synchronize
from repro_torch.core import components, conform as conform_mod, cropping, executors, patching, spatial_shard
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.core.spatial_shard import ShardGeometryError
from repro_torch.kernels import quantize
from repro_torch.telemetry.budget import BudgetExceeded, MemoryBudget
from repro_torch.telemetry.record import StageTimes, TelemetryRecord


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline options (one Brainchop 'model card')."""

    name: str = "gwm_light"
    model: MeshNetConfig = dataclasses.field(default_factory=MeshNetConfig)
    volume_shape: tuple[int, int, int] = (256, 256, 256)
    # inference mode: "full" | "subvolume" | "streaming"
    mode: str = "full"
    # forward implementation: "auto" | "torch" | "cuda_fused" |
    # "cuda_megakernel" | "streaming" | "sharded_<inner>[@n]"
    executor: str = executors.AUTO
    # Z-slab count of the sharded executors: n > 1 re-wraps the executor
    # as sharded_<inner>@n, 1 forces one device, None keeps the executor
    shard_devices: Optional[int] = None
    # storage policy (kernels/quantize.py): "fp32" | "bf16" | "int8w" |
    # "auto" (fp32 in the port)
    precision: str = quantize.AUTO
    # sub-volume mode: the cube's core, its context on each side, and the
    # cubes one forward takes as a batch
    cube: int = 64
    overlap: int = patching.MESHNET_RF_RADIUS
    batch_cubes: int = 1
    use_cropping: bool = False
    crop_margin: int = 4
    min_component_size: int = 64
    postprocess: bool = True
    budget: Optional[MemoryBudget] = None
    # optional content-keyed memo for the conform stage (e.g.
    # serving.cache.ConformMemo): any object with get(vol, out_shape) ->
    # conformed-or-None and put(vol, out_shape, conformed), keyed on the
    # raw volume as the caller passed it. The memo holds the conformed
    # [0, 1] fp32 volume on the device *before* the precision cast, so one
    # conform can feed requests under different storage policies; no
    # later stage writes into it.
    conform_memo: Optional[Any] = None


@dataclasses.dataclass
class PipelineResult:
    segmentation: Optional[torch.Tensor]
    record: TelemetryRecord


def _now() -> float:
    return time.perf_counter()


def _geometry_fail_type(e: ValueError) -> str:
    """The record's fail type for a ValueError out of the pre-flight: slab
    geometry (``ShardGeometryError``: Z does not divide, devices lacking)
    has its own; any other is an unplannable schedule."""
    return "shard_geometry" if isinstance(e, ShardGeometryError) else "vmem_oom"


def _with_shards(exec_name: str, shard_devices: Optional[int]) -> str:
    """The executor that runs for ``shard_devices``: a shardable executor
    re-wrapped pinned to that many slabs (a name that pins its own count,
    ``sharded_torch@8``, is an explicit request and wins); 1 unwraps a
    sharded name; an executor with no sharded form (``streaming``) stays
    on one device."""
    if shard_devices is None:
        return exec_name
    inner = executors.inner_of(exec_name)
    parsed = executors.parse_sharded(exec_name)
    pinned = parsed is not None and parsed[1] is not None
    if shard_devices > 1 and executors.shardable(inner) and not pinned:
        return executors.ensure_sharded(inner, shard_devices)
    if shard_devices <= 1:
        return inner
    return exec_name


def run(
    cfg: PipelineConfig,
    params: Any,
    vol,
    *,
    mask_model: Optional[tuple[Any, MeshNetConfig]] = None,
    voxel_size=(1.0, 1.0, 1.0),
    device=None,
) -> PipelineResult:
    """Run the pipeline on one raw (D, H, W) volume (tensor or numpy) on
    ``device`` (None: the CUDA card, which must exist). ``params`` and the
    mask model's params must already be on that device."""
    dev = resolve_device(device)
    times = StageTimes()
    # "auto" is resolved against the shape each forward sees: the padded
    # cube in sub-volume mode.
    cube_shape = (cfg.cube + 2 * cfg.overlap,) * 3
    work_shape = cube_shape if cfg.mode == "subvolume" else cfg.volume_shape
    precision = quantize.resolve_precision(cfg.precision, cfg.model)
    exec_name = _with_shards(
        executors.resolve(cfg.executor, cfg.model, work_shape, precision, device=dev), cfg.shard_devices
    )
    rec = TelemetryRecord(
        model=cfg.name,
        mode=cfg.mode,
        status="ok",
        times=times,
        executor=exec_name,
        precision=precision,
        params_bytes=quantize.model_params_bytes(cfg.model, precision),
        memory_budget_bytes=None if cfg.budget is None else cfg.budget.bytes_limit,
        collective_bytes_modeled=0,
    )
    try:
        # The sharded family's devices must exist: the same error the
        # forward would raise, before any compute.
        parsed = executors.parse_sharded(exec_name)
        if parsed is not None:
            spatial_shard.mesh_for(parsed[1], dev.type)
        # Price the forward's device-memory traffic before any compute. For
        # the megakernel this plans the schedule, so a plan that fits no
        # block's shared memory fails the run here; the mask forward runs
        # under the same executor, so its model is planned too.
        # In sub-volume mode the model is the cube's, times the cubes.
        if cfg.mode == "subvolume":
            ncubes = math.prod(-(-s // cfg.cube) for s in cfg.volume_shape)
            per_cube = executors.modeled_hbm_bytes(
                exec_name, cfg.model, cube_shape, precision=precision, device=dev
            )
            rec.hbm_bytes_modeled = None if per_cube is None else ncubes * per_cube
            rec.collective_bytes_modeled = ncubes * executors.modeled_collective_bytes(
                exec_name, cfg.model, cube_shape, precision=precision, device=dev
            )
        else:
            rec.hbm_bytes_modeled = executors.modeled_hbm_bytes(
                exec_name, cfg.model, cfg.volume_shape, precision=precision, device=dev
            )
            rec.collective_bytes_modeled = executors.modeled_collective_bytes(
                exec_name, cfg.model, cfg.volume_shape, precision=precision, device=dev
            )
        if cfg.use_cropping and mask_model is not None:
            executors.modeled_hbm_bytes(
                exec_name, mask_model[1], cfg.volume_shape, precision=precision, device=dev
            )
    except ValueError as e:
        rec.status = "fail"
        # "vmem_oom" is the reference's name for an unplannable schedule
        rec.fail_type = _geometry_fail_type(e)
        return PipelineResult(segmentation=None, record=rec)
    budget = cfg.budget or MemoryBudget.unlimited()
    act_bytes = quantize.act_bytes(precision)
    try:
        # --- Stage 1: preprocessing (to the device, conform, policy cast) --
        t0 = _now()
        x = None
        if cfg.conform_memo is not None:
            x = cfg.conform_memo.get(vol, cfg.volume_shape)
        if x is None:
            x = conform_mod.conform(torch.as_tensor(vol, dtype=torch.float32, device=dev), cfg.volume_shape, voxel_size)
            if cfg.conform_memo is not None:
                cfg.conform_memo.put(vol, cfg.volume_shape, x)
        x = x.to(dev)
        # The conformed [0, 1] volume leaves preprocessing in the policy's
        # storage type, so the forwards below read it at that width.
        if precision == "int8w":
            x = quantize.quantize_input(x)
        elif precision == "bf16":
            x = x.to(quantize.act_dtype(precision))
        synchronize(dev)
        times.preprocessing = _now() - t0

        crop_start = None
        full_shape = tuple(x.shape)
        # --- Stage 2: cropping (optional) ------------------------------------
        if cfg.use_cropping and mask_model is not None:
            t0 = _now()
            mparams, mcfg = mask_model
            budget.charge_inference(x.shape, mcfg, dtype_bytes=act_bytes)
            mask_logits = executors.bound_apply(exec_name, precision=precision)(
                mparams, x[None], mcfg
            )
            mask = torch.argmax(mask_logits[0], -1) > 0
            mask = components.largest_component(mask)
            size = cropping.pick_crop_size(mask, margin=cfg.crop_margin)
            x, crop_start = cropping.crop_to(x, mask, size)
            synchronize(dev)
            times.cropping = _now() - t0
            rec.crop_size = size

        # --- Stage 3: inference ----------------------------------------------
        t0 = _now()
        if cfg.mode == "subvolume":
            budget.charge_subvolume(cfg.cube, cfg.overlap, cfg.model, dtype_bytes=act_bytes)
            # split, per-cube forwards and the trimmed merge, all on the
            # device and all attributed to inference
            logits = patching.subvolume_inference(
                x,
                params=params,
                model_cfg=cfg.model,
                executor=exec_name,
                cube=cfg.cube,
                overlap=cfg.overlap,
                batch_cubes=cfg.batch_cubes,
                precision=precision,
            )
        else:
            if cfg.mode == "streaming":
                budget.charge_streaming(x.shape, cfg.model, dtype_bytes=act_bytes)
                schedule = "streaming"
            else:  # full
                budget.charge_inference(x.shape, cfg.model, dtype_bytes=act_bytes)
                schedule = "apply"
            logits = executors.bound_apply(exec_name, schedule, precision)(
                params, x[None], cfg.model
            )[0]
        synchronize(dev)
        times.inference = _now() - t0

        seg = torch.argmax(logits, dim=-1).to(torch.int32)
        del logits

        # --- Stage 4: postprocessing (connected components) -------------------
        if cfg.postprocess:
            t0 = _now()
            seg = components.filter_segmentation(seg, cfg.model.num_classes, cfg.min_component_size)
            synchronize(dev)
            times.postprocessing = _now() - t0

        if crop_start is not None:
            seg = cropping.uncrop(seg, crop_start, full_shape)

        rec.status = "ok"
        return PipelineResult(segmentation=seg, record=rec)

    except BudgetExceeded as e:
        rec.status = "fail"
        rec.fail_type = e.fail_type
        return PipelineResult(segmentation=None, record=rec)
    except conform_mod.DegenerateVolumeError:
        times.preprocessing = _now() - t0
        rec.status = "fail"
        rec.fail_type = "degenerate_volume"
        return PipelineResult(segmentation=None, record=rec)
    except ShardGeometryError:
        # geometry the pre-flight cannot see: the crop picks its shape at
        # run time, and it need not divide into the slabs
        rec.status = "fail"
        rec.fail_type = "shard_geometry"
        return PipelineResult(segmentation=None, record=rec)
