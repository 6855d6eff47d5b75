"""MeshNet inference executors — counterpart of ``repro/core/executors.py``.

Every executor exposes ``apply(params, x, cfg, precision=...) -> logits``
with ``x: (B, D, H, W[, C])`` and logits ``(B, D, H, W, num_classes)``,
equal to ``meshnet.apply`` in eval mode, the leading ``B`` a true batch
axis. Built-in executors, with the reference backend each is held to
(``REFERENCE_NAMES``):

  ``torch``           — the plain forward, ``meshnet.apply`` (reference
                        ``xla``): the parity oracle, on any device.
  ``cuda_fused``      — ``ops.meshnet_apply``, one fused conv+BN+ReLU
                        kernel launch (K1) per hidden layer (reference
                        ``pallas_fused``).
  ``cuda_megakernel`` — ``ops.meshnet_apply_megakernel``, one depth-first
                        kernel launch (K2; K2r at bf16 and int8w) per
                        segment of a plan that fits one block's shared
                        memory (reference ``pallas_megakernel``).
  ``streaming``       — ``streaming.streaming_apply``, the two-live-buffer
                        layer loop (reference ``streaming``): plain PyTorch
                        by design, as the reference's is XLA.

Every executor takes ``precision`` (kernels/quantize.py): fp32, or bf16
and int8w, where ``cuda_fused`` launches K1r a layer, ``cuda_megakernel``
K2r a segment (int8 staging between segments under int8w when the model
has BatchNorm), and ``torch`` serves the plain reduced forward
(``quantize.reference_apply``).

On CPU tensors the kernels' plain versions run. ``hbm_bytes`` prices each
schedule's device-memory traffic (telemetry/traffic.py).

``"auto"`` resolves per device: ``cuda_fused`` on CUDA, ``torch`` on the
CPU. The reference prefers its megakernel whenever the plan fits; the
port does not yet. K1's and K2's layers are bound by the fp32 FMA rate of
the CUDA cores, and the depth-first schedule saves bytes but adds the
halo's recompute, so on fp32 CUDA cores it cannot beat the per-layer
forward by its schedule. ``auto`` switches to ``cuda_megakernel`` when
its whole forward at the served shape takes less time on the card than
``cuda_fused``'s in the same run (``chip_smoke.py`` phase 6 times both);
until then the megakernel is chosen only by name.

``streaming_apply`` is what mode ``"streaming"`` runs: the streaming
schedule for ``torch`` and ``streaming``, as the reference's ``xla``; for
the kernel paths the same forward, since each layer's activation is read
by one next launch and freed when it is replaced.

The sharded family ``sharded_<inner>[@n]`` (core/spatial_shard.py) wraps
``torch``, ``cuda_fused`` or ``cuda_megakernel`` and runs it on ``n``
Z-slabs (all the host's devices of the input's kind without ``@n``); its
specs are registered on first use (``resolve``, ``ensure_sharded``) and
price the halo traffic between devices (``collective_bytes``). ``auto``
never picks it: on a host with several cards that waits for a measurement
there (ROADMAP Queue 2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import spatial_shard, streaming
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.kernels import ops, quantize
from repro_torch.telemetry import traffic

ApplyFn = Callable[..., torch.Tensor]
BytesFn = Callable[..., Optional[int]]

#: name prefix of the Z-sharded wrapper family (core/spatial_shard.py).
SHARDED_PREFIX = "sharded_"


#: the port's backend names -> the reference backends they are held to
#: (``reference_name`` maps the sharded family too).
REFERENCE_NAMES = {
    "torch": "xla",
    "cuda_fused": "pallas_fused",
    "cuda_megakernel": "pallas_megakernel",
    "streaming": "streaming",
}


@dataclasses.dataclass(frozen=True)
class ExecutorSpec:
    """One inference backend. ``hbm_bytes(cfg, vol, batch=1,
    precision="fp32")`` prices the schedule's device-memory traffic; None
    where the schedule has no model. ``collective_bytes`` (same
    signature) prices the halo traffic between devices: None for a
    single-device backend (modeled as zero)."""

    name: str
    apply: ApplyFn
    streaming_apply: ApplyFn
    description: str = ""
    hbm_bytes: Optional[BytesFn] = None
    collective_bytes: Optional[BytesFn] = None


_REGISTRY: dict[str, ExecutorSpec] = {}
_BOUND: dict[tuple[str, str, str], Callable] = {}

#: the name PipelineConfig defaults to; resolved per device at run time.
AUTO = "auto"


def register(spec: ExecutorSpec) -> ExecutorSpec:
    _REGISTRY[spec.name] = spec
    for key in [k for k in _BOUND if k[0] == spec.name]:
        _BOUND.pop(key, None)
    return spec


def names() -> list[str]:
    """Registered executor names (stable order of registration), less the
    sharded family, whose names are open-ended and registered on first
    use."""
    return [n for n in _REGISTRY if not n.startswith(SHARDED_PREFIX)]


def sharded_name(inner: str, num_devices: Optional[int] = None) -> str:
    """Registry name of the sharded wrapper around ``inner``:
    ``sharded_<inner>`` (all the host's devices) or ``sharded_<inner>@<n>``."""
    base = SHARDED_PREFIX + inner
    return base if num_devices is None else f"{base}@{num_devices}"


def parse_sharded(name: str) -> Optional[tuple[str, Optional[int]]]:
    """(inner, num_devices) for a sharded-family name, else None. Raises
    KeyError for a sharded name whose inner is not shardable or whose slab
    count is not a positive integer."""
    if not name.startswith(SHARDED_PREFIX):
        return None
    inner, _, n = name[len(SHARDED_PREFIX):].partition("@")
    if inner not in spatial_shard.SHARDED_INNERS:
        raise KeyError(
            f"unknown executor {name!r}: sharded inner must be one of {sorted(spatial_shard.SHARDED_INNERS)}"
        )
    if n and (not n.isdigit() or int(n) < 1):
        raise KeyError(f"unknown executor {name!r}: slab count after '@' must be a positive integer")
    return inner, (int(n) if n else None)


def inner_of(name: str) -> str:
    """The single-device backend behind a sharded name (the name itself
    otherwise): what a device-count override re-wraps."""
    parsed = parse_sharded(name)
    return parsed[0] if parsed else name


def reference_name(name: str) -> str:
    """The reference backend a port executor is held to:
    ``REFERENCE_NAMES`` for a base name, and ``sharded_<inner>[@n]`` ->
    ``sharded_<reference inner>[@n]``. KeyError for any other name."""
    parsed = parse_sharded(name)
    if parsed is None:
        return REFERENCE_NAMES[name]
    inner, n = parsed
    return sharded_name(REFERENCE_NAMES[inner], n)


def shardable(name: str) -> bool:
    """Whether the (inner of the) named executor has a sharded form."""
    return inner_of(name) in spatial_shard.SHARDED_INNERS


def _make_sharded_spec(inner: str, num_devices: Optional[int]) -> ExecutorSpec:
    def _apply(params, x, cfg, precision: str = "fp32"):
        return spatial_shard.sharded_executor_apply(inner, params, x, cfg, num_devices=num_devices, precision=precision)

    def _hbm(cfg, vol, batch: int = 1, precision: str = "fp32"):
        n = num_devices or spatial_shard.device_count()
        return traffic.meshnet_sharded_bytes(inner, cfg, vol, n, batch=batch, precision=precision)

    def _collective(cfg, vol, batch: int = 1, precision: str = "fp32"):
        n = num_devices or spatial_shard.device_count()
        return traffic.meshnet_collective_bytes(cfg, vol, n, batch=batch, precision=precision)

    slabs = f"{num_devices} Z-slabs" if num_devices else "one Z-slab per device"
    return ExecutorSpec(
        name=sharded_name(inner, num_devices),
        apply=_apply,
        streaming_apply=_apply,
        description=f"halo-exchange wrapper over {inner!r} ({slabs})",
        hbm_bytes=_hbm,
        collective_bytes=_collective,
    )


def ensure_sharded(inner_or_name: str, num_devices: Optional[int] = None) -> str:
    """Register (once) and return the sharded wrapper's name. Takes a bare
    inner (``"cuda_fused"``) or a sharded name (``"sharded_cuda_fused"``,
    re-pinned to ``num_devices`` when given): how the pipeline's
    ``shard_devices`` and the engine's per-request device count make their
    specs."""
    inner = inner_of(inner_or_name)
    if inner not in spatial_shard.SHARDED_INNERS:
        raise KeyError(
            f"executor {inner!r} cannot be sharded; supported inners: {sorted(spatial_shard.SHARDED_INNERS)}"
        )
    name = sharded_name(inner, num_devices)
    if name not in _REGISTRY:
        register(_make_sharded_spec(inner, num_devices))
    return name


def default_executor(
    model: Optional[MeshNetConfig] = None,
    volume_shape: Optional[tuple[int, int, int]] = None,
    *,
    device=None,
    precision: str = "fp32",
) -> str:
    """``cuda_fused`` on a CUDA device, ``torch`` on the CPU, whatever the
    model, volume and precision (the reference's signature, so callers
    resolve as they do there). ``device=None`` asks whether this host has
    a card. Not ``cuda_megakernel``, though the reference prefers its
    megakernel: at fp32 on the CUDA cores K2 does the per-layer work plus
    the halo's recompute, so it waits until it beats the per-layer forward
    on the card (see the module docstring)."""
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    return "cuda_fused" if cuda else "torch"


def resolve(
    name: Optional[str],
    model: Optional[MeshNetConfig] = None,
    volume_shape: Optional[tuple[int, int, int]] = None,
    precision: str = "fp32",
    *,
    device=None,
) -> str:
    """Map None/"auto" to the device's default (given the model, shape and
    precision, as the reference's); validate explicit names. A sharded
    name (``sharded_<inner>[@n]``) registers its spec on first use."""
    if name is None or name == AUTO:
        return default_executor(model, volume_shape, device=device, precision=precision)
    if name not in _REGISTRY:
        parsed = parse_sharded(name)  # KeyError on a bad sharded inner
        if parsed is not None:
            return ensure_sharded(*parsed)
        raise KeyError(f"unknown executor {name!r}; registered: {sorted(_REGISTRY)} (or 'auto')")
    return name


def get(name: Optional[str], *, device=None) -> ExecutorSpec:
    """Fetch an executor spec, resolving "auto"."""
    return _REGISTRY[resolve(name, device=device)]


def apply(name: Optional[str], params, x: torch.Tensor, cfg: MeshNetConfig, precision: str = "fp32") -> torch.Tensor:
    """One-shot dispatch of ``x`` through the named executor."""
    return get(name, device=x.device).apply(params, x, cfg, precision=precision)


def bound_apply(
    name: Optional[str], schedule: str = "apply", precision: str = "fp32", *, device=None
) -> Callable[[Any, torch.Tensor, MeshNetConfig], torch.Tensor]:
    """The executor's forward with its precision bound in, as a 3-arg
    ``(params, x, cfg)`` callable, cached per (executor, schedule,
    precision): the counterpart of the reference's ``jitted_apply`` (eager
    PyTorch compiles nothing, so only the binding is cached).
    ``schedule="streaming"`` selects ``streaming_apply``."""
    if schedule not in ("apply", "streaming"):
        raise ValueError(f"schedule must be 'apply' or 'streaming', got {schedule!r}")
    quantize.validate(precision)
    key = (resolve(name, device=device), schedule, precision)
    if key not in _BOUND:
        spec = _REGISTRY[key[0]]
        fn = spec.apply if schedule == "apply" else spec.streaming_apply

        def bound(params, x, cfg, _fn=fn, _p=precision):
            return _fn(params, x, cfg, precision=_p)

        _BOUND[key] = bound
    return _BOUND[key]


def make_infer(
    name: Optional[str],
    params,
    cfg: MeshNetConfig,
    volume_shape: Optional[tuple[int, int, int]] = None,
    precision: str = "fp32",
    *,
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-block closure of sub-volume patching: (B, d, h, w[, C])
    cubes -> (B, d, h, w, classes), over the ``bound_apply`` cache.
    ``volume_shape`` is the cube shape the closure serves, the shape
    "auto" is resolved against."""
    fn = bound_apply(resolve(name, cfg, volume_shape, precision, device=device), precision=precision, device=device)

    def infer(c: torch.Tensor) -> torch.Tensor:
        return fn(params, c, cfg)

    return infer


def modeled_hbm_bytes(
    name: Optional[str],
    cfg: MeshNetConfig,
    volume_shape: tuple[int, int, int],
    batch: int = 1,
    precision: str = "fp32",
    *,
    device=None,
) -> Optional[int]:
    """Modeled device-memory bytes of one forward under the named
    executor's schedule, or None if the backend has no model. Plans the
    megakernel, so an unplannable one raises ValueError here."""
    spec = get(name, device=device)
    if spec.hbm_bytes is None:
        return None
    return spec.hbm_bytes(cfg, volume_shape, batch=batch, precision=precision)


def modeled_collective_bytes(
    name: Optional[str],
    cfg: MeshNetConfig,
    volume_shape: tuple[int, int, int],
    batch: int = 1,
    precision: str = "fp32",
    *,
    device=None,
) -> int:
    """Modeled halo bytes between devices of one forward under the named
    executor: 0 for a single-device backend, the sharded family's
    ``traffic.meshnet_collective_bytes``."""
    spec = get(name, device=device)
    if spec.collective_bytes is None:
        return 0
    return spec.collective_bytes(cfg, volume_shape, batch=batch, precision=precision)


def _torch_apply(params, x, cfg, precision: str = "fp32"):
    return quantize.reference_apply(params, x, cfg, precision)


register(
    ExecutorSpec(
        name="torch",
        apply=_torch_apply,
        streaming_apply=streaming.streaming_apply,
        description="plain PyTorch forward (meshnet.apply; quantize.reference_apply "
        "at bf16/int8w); parity oracle",
        hbm_bytes=traffic.meshnet_plain_bytes,
    )
)

register(
    ExecutorSpec(
        name="cuda_fused",
        apply=ops.meshnet_apply,
        streaming_apply=ops.meshnet_apply,
        description="fused CUDA conv+BN+ReLU kernel per layer",
        hbm_bytes=traffic.meshnet_fused_bytes,
    )
)

register(
    ExecutorSpec(
        name="cuda_megakernel",
        apply=ops.meshnet_apply_megakernel,
        streaming_apply=ops.meshnet_apply_megakernel,
        description="depth-first CUDA kernel per segment of a shared-memory plan",
        hbm_bytes=traffic.meshnet_megakernel_bytes,
    )
)

register(
    ExecutorSpec(
        name="streaming",
        apply=streaming.streaming_apply,
        streaming_apply=streaming.streaming_apply,
        description="layer loop over stacked layers; memory-floor schedule",
        hbm_bytes=traffic.meshnet_streaming_bytes,
    )
)
