"""Sub-volume patching — counterpart of ``repro/core/patching.py``.

Brainchop's failsafe inference mode: when the full volume does not fit in
memory, the volume is divided into overlapping sub-cubes (the paper's
``CubeDivider``), each cube is inferred on its own, and the cubes' cores
are merged back. With ``overlap`` at least the receptive-field radius
(``MESHNET_RF_RADIUS``, 46 for the Table-I schedule) the trimmed merge is
exact for every voxel at least that far from the volume's boundary; nearer
the boundary a cube zero-pads only at its own edge where the full-volume
forward zero-pads at every layer, the sub-volume accuracy loss the paper
reports.

All cubes share one shape (the tail is padded to a whole cube), so each
forward runs at one shape. The merge stays on the device: the reference
copies the cubes through host numpy, a detail of its arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

MESHNET_RF_RADIUS = 46  # sum((1,2,4,8,16,8,4,2,1)) * (3-1)/2


@dataclasses.dataclass(frozen=True)
class CubeSpec:
    """One sub-cube: where it reads and writes."""

    src_start: tuple[int, int, int]  # read origin in the padded volume
    dst_start: tuple[int, int, int]  # write origin in the output volume
    trim_lo: tuple[int, int, int]  # voxels trimmed from the cube's output (low side)
    core: tuple[int, int, int]  # size of the region written back


class CubeDivider:
    """Splits a (D, H, W[, C]) volume into overlapping cubes and merges back.

    ``cube`` is the core (written-back) size per axis; each cube is read
    with ``overlap`` extra context on every side (zero-padded at the
    volume's borders), so the model sees ``cube + 2 * overlap`` per axis.
    """

    def __init__(self, shape: tuple[int, int, int], cube: int = 64, overlap: int = MESHNET_RF_RADIUS):
        self.shape = tuple(int(s) for s in shape)
        self.cube = cube
        self.overlap = overlap
        self.specs: list[CubeSpec] = []
        grids = [range(0, s, cube) for s in self.shape]
        for z0 in grids[0]:
            for y0 in grids[1]:
                for x0 in grids[2]:
                    core = tuple(min(cube, s - o) for s, o in zip(self.shape, (z0, y0, x0)))
                    self.specs.append(
                        CubeSpec(
                            src_start=(z0, y0, x0),  # origin in the padded volume == core origin
                            dst_start=(z0, y0, x0),
                            trim_lo=(overlap, overlap, overlap),
                            core=core,
                        )
                    )

    @property
    def num_cubes(self) -> int:
        return len(self.specs)

    @property
    def read_size(self) -> tuple[int, int, int]:
        return tuple(self.cube + 2 * self.overlap for _ in range(3))

    def split(self, vol: torch.Tensor) -> list[torch.Tensor]:
        """The padded cubes, views of one padded copy. vol: (D, H, W) or
        (D, H, W, C). The tail is padded by ``overlap + cube``, so every
        read is full-size."""
        has_c = vol.ndim == 4
        lo, hi = self.overlap, self.overlap + self.cube
        pad = (lo, hi) * 3
        padded = F.pad(vol, ((0, 0) if has_c else ()) + pad)
        rs = self.read_size
        return [
            padded[tuple(slice(s, s + r) for s, r in zip(spec.src_start, rs))]
            for spec in self.specs
        ]

    def merge(self, cubes: list[torch.Tensor], out_channels: Optional[int] = None) -> torch.Tensor:
        """Merge per-cube outputs (each ``read_size`` (+ C)) into a full
        volume on their device, writing back each cube's core only."""
        c = cubes[0].shape[-1] if cubes[0].ndim == 4 else None
        if out_channels is not None:
            c = out_channels
        shape = self.shape + ((c,) if c else ())
        out = torch.zeros(shape, dtype=cubes[0].dtype, device=cubes[0].device)
        for spec, cube in zip(self.specs, cubes):
            t = spec.trim_lo
            core = cube[t[0] : t[0] + spec.core[0], t[1] : t[1] + spec.core[1], t[2] : t[2] + spec.core[2]]
            out[tuple(slice(s, s + n) for s, n in zip(spec.dst_start, spec.core))] = core
        return out


def subvolume_inference(
    vol: torch.Tensor,
    infer_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    params=None,
    model_cfg=None,
    executor: Optional[str] = None,
    cube: int = 64,
    overlap: int = MESHNET_RF_RADIUS,
    batch_cubes: int = 1,
    precision: str = "fp32",
) -> torch.Tensor:
    """Per-cube inference over the sub-cubes of ``vol`` (D, H, W[, C]),
    merged (the failsafe). The per-cube forward is either ``infer_fn``
    mapping (B, d, h, w) -> (B, d, h, w, classes), or, given ``params``
    and ``model_cfg`` instead, the executor registry's closure
    (``executors.make_infer``) for ``executor`` ("auto" judged on the
    cube's read shape) at ``precision``. ``batch_cubes`` cubes go through
    one forward as a batch; the tail batch is padded with zero cubes so
    every forward has one shape."""
    if infer_fn is None:
        if params is None or model_cfg is None:
            raise ValueError("pass infer_fn, or params + model_cfg (+ executor)")
        from repro_torch.core import executors

        # zero-padded cube borders are exact at every policy: 0 is exact
        # in bf16 and is int8 quantization's zero point
        read = (cube + 2 * overlap,) * 3
        infer_fn = executors.make_infer(executor, params, model_cfg, read, precision=precision, device=vol.device)
    elif params is not None or model_cfg is not None or executor is not None:
        raise ValueError(
            "pass either infer_fn or params/model_cfg/executor, not both: an explicit "
            "infer_fn would shadow the executor choice"
        )
    divider = CubeDivider(vol.shape[:3], cube=cube, overlap=overlap)
    cubes = divider.split(vol)
    outs: list[torch.Tensor] = []
    for i in range(0, len(cubes), batch_cubes):
        chunk = cubes[i : i + batch_cubes]
        n = len(chunk)
        if n < batch_cubes:
            chunk = chunk + [torch.zeros_like(chunk[0])] * (batch_cubes - n)
        res = infer_fn(torch.stack(chunk))
        outs.extend(res[:n].unbind(0))
    return divider.merge(outs)


def memory_bytes_full_volume(shape, channels, num_classes, dtype_bytes=4) -> int:
    """Peak activation bytes of full-volume MeshNet inference (two live
    activation buffers under layer-streaming + the logits buffer)."""
    vox = math.prod(shape)
    return vox * channels * dtype_bytes * 2 + vox * num_classes * dtype_bytes


def memory_bytes_subvolume(cube, overlap, channels, num_classes, dtype_bytes=4) -> int:
    side = cube + 2 * overlap
    return memory_bytes_full_volume((side,) * 3, channels, num_classes, dtype_bytes)
