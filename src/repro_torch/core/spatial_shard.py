"""Z-sharded MeshNet inference over several devices — counterpart of
``repro/core/spatial_shard.py``.

The volume is cut into Z-slabs, one a device. Before every dilated conv
layer each slab receives ``dilation`` Z-slices of context ("halo") from
its neighbours, so the slab's valid-Z conv equals the full-volume conv;
the volume's ends receive zeros, which is the volume's per-layer 'same'
zero padding, so the result has no boundary band (unlike sub-volume
patching). Slabs thinner than the halo take it *multi-hop*: from as many
neighbours as it spans, the farthest trimmed, so any geometry with
``D % slabs == 0`` is exact.

One process drives every slab, as the reference's one ``shard_map``
program does. A slab's device comes from a device list
(``mesh_for``): by default the first ``n`` of the host's devices of the
input's kind, ``cuda:0 .. k-1``, or the one CPU.
``sharded_executor_apply(..., devices=[...])`` takes an explicit list,
which may repeat a device: several slabs on one card, or the CPU tests'
``["cpu"] * n``, the counterpart of XLA's forced host device count. The halo exchange copies each neighbour's
slices onto the receiving slab's device (``.to(device)``: a peer copy
between two cards, a plain copy or none on one). Slabs run one after
another.

The sharded executor family of the registry (core/executors.py) wraps a
single-device inner and runs it per slab:

  * ``torch`` inner — per-layer halo exchange + valid-Z plain conv
    (reference ``xla``);
  * ``cuda_fused`` inner — per-layer halo exchange + K1 (K1r) 'same' on
    the extended slab, cropped back (reference ``pallas_fused``);
  * ``cuda_megakernel`` inner — ONE multi-hop exchange of the whole
    receptive-field radius (sum(dilations) = 46), then the depth-first
    forward on the slab + halo window (its plan made for that shape) with
    the window's valid Z interval as ``z_bounds`` (K2z, K2r-z), so the
    per-layer zero padding happens at the volume's ends and not at the
    window's (reference ``pallas_megakernel``).

Each equals its single-device inner: 1e-4 at fp32, 2e-2 at bf16 and int8w
(tests/test_torch_spatial_shard.py). The reduced policies keep the
reference's rounding points: bf16 halos for the layer-wise inners, and for
the megakernel inner at int8w the input quantised before the exchange, so
int8 crosses; params are prepared once, outside the slab loop.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core import meshnet
from repro_torch.core.meshnet import MeshNetConfig
from repro_torch.kernels import ops, quantize, ref

class ShardGeometryError(ValueError):
    """The requested slab geometry cannot run: the Z dim does not divide
    into the slab count, or the host lacks the devices. The pipeline maps
    this to a failed telemetry record (fail_type='shard_geometry') instead
    of letting it escape, unlike other ValueErrors."""


def host_devices(kind: Optional[str] = None) -> list[torch.device]:
    """The host's devices of ``kind`` ("cuda" or "cpu"; None: "cuda" when a
    card exists, else "cpu"): ``cuda:0 .. k-1``, or the one CPU."""
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no device list for device kind {kind!r}")


def device_count(kind: Optional[str] = None) -> int:
    return len(host_devices(kind))


def mesh_for(num_devices: Optional[int] = None, kind: Optional[str] = None) -> list[torch.device]:
    """The first ``num_devices`` (None: all) of the host's devices of
    ``kind``, one a Z-slab; ``ShardGeometryError`` when the host has
    fewer."""
    devs = host_devices(kind)
    n = num_devices or len(devs)
    if n > len(devs):
        raise ShardGeometryError(f"sharded executor wants {n} devices; host has {len(devs)}")
    return devs[:n]


def mesh_for_batched(batch_shards: int, num_devices: int, kind: Optional[str] = None) -> list[list[torch.device]]:
    """A (batch, Z) grid: ``batch_shards`` rows of ``num_devices`` slab
    devices. Each row runs the whole slab schedule on its share of the
    batch; halos cross only within a row, so the numbers are the 1-D
    mesh's."""
    total = batch_shards * num_devices
    devs = host_devices(kind)
    if total > len(devs):
        raise ShardGeometryError(
            f"batched sharded executor wants {batch_shards}x{num_devices} devices; host has {len(devs)}"
        )
    return [devs[r * num_devices : (r + 1) * num_devices] for r in range(batch_shards)]


def auto_batch_shards(batch: int, num_devices: int, kind: Optional[str] = None) -> int:
    """The largest batch-axis size the host can add on top of
    ``num_devices`` Z slabs: the biggest divisor of ``batch`` with ``k *
    num_devices`` devices available; 1 when there are no spare devices."""
    spare = device_count(kind) // max(num_devices, 1)
    for k in range(min(int(batch), spare), 1, -1):
        if batch % k == 0:
            return k
    return 1


def _fetch(slabs: Sequence[torch.Tensor], src: int, dst: torch.Tensor, trim: Optional[slice]) -> torch.Tensor:
    """Slab ``src`` (its Z rows ``trim``, all when None) on ``dst``'s
    device; zeros where no such slab exists (the volume's zero padding)."""
    if 0 <= src < len(slabs):
        piece = slabs[src] if trim is None else slabs[src][:, trim]
        return piece.to(dst.device)
    depth = dst.shape[1] if trim is None else len(range(dst.shape[1])[trim])
    return torch.zeros((dst.shape[0], depth) + tuple(dst.shape[2:]), dtype=dst.dtype, device=dst.device)


def halo_exchange_z(slabs: Sequence[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Each slab (B, dloc, H, W, C) with ``halo`` Z-slices of its
    neighbours' on both sides -> (B, dloc + 2 halo, H, W, C), on its own
    device. The volume's ends receive zeros. A halo wider than a slab is
    fetched multi-hop: ceil(halo / dloc) neighbours a side, the farthest
    trimmed to the remainder, farthest first, so the Z order is the
    global order; one exchange of ``n * h`` gives exactly the context of
    ``n`` exchanges of ``h`` (tests/test_torch_spatial_shard.py)."""
    if halo == 0:
        return list(slabs)
    if len(slabs) == 1:
        return [F.pad(slabs[0], (0, 0, 0, 0, 0, 0, halo, halo))]
    dloc = slabs[0].shape[1]
    hops = -(-halo // dloc)
    rem = halo - (hops - 1) * dloc  # slices taken from the farthest hop
    out = []
    for i, x in enumerate(slabs):
        left = [_fetch(slabs, i - j, x, slice(dloc - rem, dloc) if j == hops and rem < dloc else None)
                for j in range(hops, 0, -1)]
        right = [_fetch(slabs, i + j, x, slice(0, rem) if j == hops and rem < dloc else None)
                 for j in range(1, hops + 1)]
        out.append(torch.cat(left + [x] + right, 1))
    return out


def _conv_layer_slab(layer: dict, x: torch.Tensor, dilation: int, cfg: MeshNetConfig, precision: str = "fp32"):
    """One MeshNet block on a slab already extended by ``dilation`` a side
    (``halo_exchange_z``): valid-Z conv ('same' in H and W), BatchNorm,
    ReLU. At a reduced policy, ``quantize.conv_block_reduced`` without Z
    padding: fp32 accumulation and epilogue, one round to bf16 at the
    output, the single-device plain forward's rounding points."""
    if precision == "fp32":
        out = ref.dilated_conv3d(x, layer["w"], layer["b"], dilation=dilation, z_same=False)
        if cfg.use_batchnorm:
            out = meshnet.batchnorm(out, layer)[0]
        return torch.relu(out)
    return quantize.conv_block_reduced(x, layer, dilation, cfg.use_batchnorm, z_same=False)


def _head(params, x: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    if precision == "fp32":
        head = params["head"]
        return torch.einsum("bdhwi,io->bdhwo", x, head["w"][0, 0, 0]) + head["b"]
    return quantize.head_reduced(x, params["head"])


def _dequant_slab_input(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A slab in the policy's activation dtype before the layer-wise
    schedules (``quantize.cast_input``): under int8w a float input snaps
    to the int8 grid first, so slab parity with the single-device forwards
    is exact."""
    if precision == "fp32":
        return x
    return quantize.cast_input(x, precision)


def _slab_torch(params: list, slabs: list, cfg: MeshNetConfig, precision: str = "fp32") -> list:
    """Layer-wise schedule, plain inner: exchange d, valid-Z conv, repeat.
    ``params[i]`` is the params tree on slab i's device."""
    xs = [_dequant_slab_input(x, precision) for x in slabs]
    for li, d in enumerate(cfg.dilations):
        xs = [_conv_layer_slab(p["layers"][li], e, d, cfg, precision) for p, e in zip(params, halo_exchange_z(xs, d))]
    return [_head(p, x, precision) for p, x in zip(params, xs)]


def _fused_layer(layer: dict, x: torch.Tensor, d: int, cfg: MeshNetConfig, precision: str) -> torch.Tensor:
    """K1 (K1r) 'same' on the extended slab, the d-band each side cropped
    off: an output d or more from the extended edge taps only data inside
    it, so the crop is exact."""
    if precision != "fp32":
        bias, scale, offset = quantize.fold_epilogue(layer, cfg.use_batchnorm)
    elif cfg.use_batchnorm:
        bias = layer["b"]
        scale, offset = ops.fold_batchnorm(layer)
    else:
        bias, scale, offset = layer["b"], None, None
    out = ops.dilated_conv3d(x, layer["w"], bias, dilation=d, scale=scale, offset=offset, fuse_affine=True)
    return out[:, d:-d]


def _slab_fused(params: list, slabs: list, cfg: MeshNetConfig, precision: str = "fp32") -> list:
    """Layer-wise schedule, fused inner: exchange d, one K1 (K1r) launch a
    slab on the extended slab, crop. The params arrive prepared."""
    xs = [_dequant_slab_input(x, precision) for x in slabs]
    for li, d in enumerate(cfg.dilations):
        xs = [_fused_layer(p["layers"][li], e, d, cfg, precision) for p, e in zip(params, halo_exchange_z(xs, d))]
    return [_head(p, x, precision) for p, x in zip(params, xs)]


def window_z_bounds(i: int, dloc: int, n: int, radius: int) -> tuple[int, int]:
    """Slab i's window of ``dloc + 2 radius`` rows holds global row
    ``i dloc - radius + z`` at local row z, so the volume's rows [0, n
    dloc) are its local rows [radius - i dloc, radius - i dloc + n dloc)."""
    g = i * dloc
    return radius - g, radius - g + n * dloc


def _slab_megakernel(params: list, slabs: list, cfg: MeshNetConfig, precision: str = "fp32") -> list:
    """One-shot schedule, megakernel inner: one multi-hop exchange of the
    whole receptive-field radius, then the depth-first forward on each
    slab + halo window (planned for the window's shape) with the window's
    valid Z interval as ``z_bounds`` (K2z, K2r-z), so per-layer zero
    padding happens at the volume's ends; a window's inner edges pollute
    only the halo band the final crop drops, and the forward computes only
    the rows the crop keeps (``rows``: each segment the band its
    successors read). Under int8w the slabs are
    quantised before the exchange (pointwise, so it commutes with it), and
    int8 crosses."""
    n, dloc = len(slabs), slabs[0].shape[1]
    radius = sum(cfg.dilations)
    if precision == "int8w":
        slabs = [x if x.dtype == torch.int8 else quantize.quantize_input(x) for x in slabs]
    elif precision == "bf16":
        slabs = [quantize.cast_input(x, precision) for x in slabs]
    out = []
    for i, (p, e) in enumerate(zip(params, halo_exchange_z(slabs, radius))):
        y = ops.meshnet_apply_megakernel(p, e, cfg, precision=precision, z_bounds=window_z_bounds(i, dloc, n, radius),
                                         rows=(radius, radius + dloc))
        out.append(y[:, radius : radius + dloc])
    return out


_SLAB_FNS = {
    "torch": _slab_torch,
    "cuda_fused": _slab_fused,
    "cuda_megakernel": _slab_megakernel,
}

#: single-device executors the sharded wrapper accepts as inners.
SHARDED_INNERS = tuple(_SLAB_FNS)


def replicate_params(params: Any, devices: Sequence) -> dict:
    """``{device: params on it}`` for every distinct device: MeshNet's
    weights are kilobytes, so every slab's device holds all of them."""
    return {d: tree.map(lambda t, _d=d: t.to(_d), params) for d in dict.fromkeys(torch.device(d) for d in devices)}


def sharded_executor_apply(
    inner: str,
    params,
    x: torch.Tensor,
    cfg: MeshNetConfig,
    *,
    num_devices: Optional[int] = None,
    precision: str = "fp32",
    batch_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> torch.Tensor:
    """Z-sharded MeshNet forward through the named inner executor.

    x: (B, D, H, W) or (B, D, H, W, C); D must divide by the slab count.
    Returns the logits (B, D, H, W, classes) on x's device. The registry's
    ``sharded_<inner>[@n]`` specs (core/executors.py) call this.

    Devices: ``devices`` lists them (it may repeat one); without it, the
    first ``num_devices`` (None: all) of the host's devices of x's kind
    (``mesh_for``). ``batch_shards`` adds the batch as a second axis:
    ``batch_shards`` rows of ``num_devices`` slab devices, each row serving
    ``B / batch_shards`` volumes (taken row-major from ``devices`` when
    given). ``None`` picks ``auto_batch_shards`` on the host's devices, and
    1 with an explicit list."""
    if inner not in _SLAB_FNS:
        raise KeyError(f"unknown sharded inner {inner!r}; supported: {sorted(_SLAB_FNS)}")
    quantize.validate(precision)
    if x.ndim == 4:
        x = x[..., None]
    kind = x.device.type
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    n = num_devices or (len(devices) if devices is not None else device_count(kind))
    if x.shape[1] % n:
        raise ShardGeometryError(
            f"Z dim {x.shape[1]} not divisible by {n} slabs — pick a device count that divides the volume depth"
        )
    if devices is None:
        bs = auto_batch_shards(x.shape[0], n, kind) if batch_shards is None else int(batch_shards)
        grid = mesh_for_batched(bs, n, kind) if bs > 1 else [mesh_for(n, kind)]
    else:
        bs = 1 if batch_shards is None else int(batch_shards)
        if len(devices) < bs * n:
            raise ShardGeometryError(f"sharded executor wants {bs}x{n} devices; {len(devices)} given")
        grid = [devices[r * n : (r + 1) * n] for r in range(bs)]
    if x.shape[0] % bs:
        raise ShardGeometryError(f"batch {x.shape[0]} not divisible by {bs} batch shards")
    if precision != "fp32":
        # prepared once, outside the slab loop, so every slab reads the same
        # quantised weights
        params = quantize.prepare_params(params, cfg, precision)
    replicas = replicate_params(params, [d for row in grid for d in row])
    slab_fn = _SLAB_FNS[inner]
    dloc = x.shape[1] // n
    rows = []
    for row, xb in zip(grid, x.split(x.shape[0] // bs, 0)):
        slabs = [s.to(d) for s, d in zip(xb.split(dloc, 1), row)]
        ys = slab_fn([replicas[d] for d in row], slabs, cfg, precision)
        rows.append(torch.cat([y.to(x.device) for y in ys], 1))
    return torch.cat(rows, 0)


def sharded_apply(params, x: torch.Tensor, cfg: MeshNetConfig, mesh: Sequence) -> torch.Tensor:
    """Full-volume MeshNet inference with the volume Z-sharded over the
    columns of ``mesh`` and the batch over its rows (the standalone demo;
    the registry's path is ``sharded_executor_apply``): ``mesh`` a list of
    devices (one row) or a list of rows of devices, through the ``torch``
    inner's layer-wise schedule.

    x: (B, D, H, W) or (B, D, H, W, 1); D must divide by the row length."""
    rows = [list(r) for r in mesh] if mesh and isinstance(mesh[0], (list, tuple)) else [list(mesh)]
    return sharded_executor_apply(
        "torch", params, x, cfg, num_devices=len(rows[0]), batch_shards=len(rows), devices=[d for r in rows for d in r]
    )


def make_sharded_infer(params, cfg: MeshNetConfig, mesh: Sequence):
    """The sharded inference fn of ``mesh``: (B, D, H, W) -> logits."""

    def infer(x: torch.Tensor) -> torch.Tensor:
        return sharded_apply(params, x, cfg, mesh)

    return infer
