"""Depth-first MeshNet megakernel: the planner and the wrapper of K2.

Counterpart of ``repro/kernels/megakernel.py``, at fp32, re-priced for
Hopper. The forward splits the layer stack into consecutive *segments*.
One launch of K2 (``csrc/megakernel.cu``) runs a whole segment per output
tile: the segment's first layer stages its taps from the input staging
array in device memory, the hidden layers' outputs stay in the block's
shared memory (ping and pong), and the last layer writes the tile, or the
fused 1x1x1 head's logits, into the output staging array. Positions
outside the true volume are masked to zero after every layer, which
reproduces per-layer 'same' zero padding exactly, so the staging arrays'
halo borders are never written and never read.

The reference stages each tile's haloed input window on chip. On Hopper
that window cannot fit: at d = 16 it is (t + 32)^3 * 5 * 4 bytes, over
700 KB even at a tile of 1, against 227 KB of shared memory a block. So
K2's first layer stages one box of one input row at a time, and only the
hidden activations are held whole (``_segment_smem_bytes``, exactly what
K2 allocates). Every layer runs on the conv tile core that K1 shares
(``csrc/conv_tile.cuh``): a warp computes a chunk of up to 32 R voxels of
one output row.

The planner picks segment boundaries and per-axis tiles by dynamic
programming over modeled device time (``_segment_modeled_ms``): per
segment the larger of its multiply-adds as K2's warps issue them over the
card's fp32 FMA rate and its device-memory bytes as K2 moves them
(``_segment_device_bytes``) over the memory rate, scaled by the wave
quantisation of its blocks on the card's SMs.
``MegakernelPlan.modeled_ms`` reports that objective;
``MegakernelPlan.hbm_bytes`` still reports the reference's byte formula
(``_segment_hbm_bytes``) on the chosen segments, and
``MegakernelPlan.operations`` counts K2's multiply-adds, halo recompute
included, for the bound of a forward.

A CUDA tensor launches K2 or raises; a CPU tensor takes the plain version
(``kernels/ref.py::megakernel_segment``). ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build, quantize, ref
from repro_torch.kernels import dilated_conv3d as conv

#: the planner's default budget: all the shared memory one block can use.
SMEM_BUDGET = _build.SMEM_LIMIT


class PrecisionNotPorted(ValueError):
    """K2 asked for a policy other than fp32. Not a planning failure: the
    pipeline lets it through instead of recording an unplannable run."""


def require_fp32(precision: str) -> None:
    """Raise ``PrecisionNotPorted`` unless ``precision`` is fp32: K2 at the
    bf16 and int8w policies (its int8 staging, ``deq_in`` and
    ``quant_out``, and the planner's per-role widths) is ROADMAP Queue 2's
    K2 item, the next slice of the port."""
    if quantize.validate(precision) != "fp32":
        raise PrecisionNotPorted(
            f"cuda_megakernel runs fp32 only: K2 at precision {precision!r} (int8 staging, "
            "the planner's per-role widths) comes with ROADMAP Queue 2's K2 item, the next "
            "slice of the port; use executor 'cuda_fused' or precision 'fp32'"
        )

#: per-axis tile candidates. Sizes below 8 and off the multiples of 8 let a
#: segment whose hidden activations are large still fit one block. They
#: reach 256 so that one tile can span a row of a 256^3 volume: a warp of
#: K2 covers 32 R voxels along x, 256 at C <= 10. No floor on the block
#: count is needed: the objective prices blocks and waves.
TILE_CANDIDATES = (2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64, 96, 128, 192, 256)

#: the most layers one segment may hold (the kernel's fixed dilation array).
MAX_LAYERS = 16

#: the card the planner prices, an NVIDIA H100 SXM (NVIDIA's data sheet):
#: its SMs, the fp32 FMA rate of its CUDA cores (67 TFLOP/s, two
#: operations an FMA) and its device-memory rate; each SM's shared memory
#: (228 KB, of which the card reserves 1 KB a block) and threads.
SMS = 132
FMA_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
SM_SMEM_BYTES = 233_472
BLOCK_SMEM_RESERVED = 1024
SM_THREADS = 2048

#: K2's block and each warp's ring: the conv tile core's.
WARPS = conv.WARPS
STAGES = conv.STAGES
THREADS = 32 * WARPS

#: registers a thread of K2 takes, by width (the most over the first-layer
#: channel counts built; they round up to the same multiple of 8): ptxas'
#: report for sm_90a, which chip_smoke.py phase 2 prints and
#: tests/test_torch_gpu.py holds to the runtime's occupancy. An SM's
#: 65,536 registers go to warps in units of 8 a thread.
REGISTERS = {5: 224, 10: 222, 18: 201, 21: 226}
SM_REGISTERS = 65_536

#: kernel launches since the counter was last reset (CPU calls don't count).
launches = 0

_LIB = None


def _ceil_to(x, m):
    return -(-x // m) * m


def _prod3(s):
    return s[0] * s[1] * s[2]


def _layer_sizes(tile, dilations) -> list[tuple]:
    """Per-layer region sizes: S_0 = tile + 2*halo, shrinking by 2*d per
    layer down to S_k = tile. Works on ints and on numpy int arrays."""
    halo = sum(dilations)
    sizes = [tuple(t + 2 * halo for t in tile)]
    for d in dilations:
        sizes.append(tuple(s - 2 * d for s in sizes[-1]))
    return sizes


@dataclasses.dataclass(frozen=True)
class Segment:
    """A consecutive run of hidden layers executed depth-first per tile."""

    start: int  # index of the first layer in cfg.dilations
    dilations: tuple[int, ...]
    cin: int  # input channels (in_channels for the first segment)
    channels: int  # hidden width C
    tile: tuple[int, int, int]
    fuse_head: bool = False  # apply the 1x1x1 head after the last layer
    num_classes: int = 0

    @property
    def halo(self) -> int:
        return sum(self.dilations)

    @property
    def cout(self) -> int:
        return self.num_classes if self.fuse_head else self.channels

    def buffer_sizes(self) -> list[tuple[int, int, int]]:
        """Per-layer valid-region sizes: S_0 = tile + 2*halo shrinking by
        2*d per layer down to S_k = tile exactly."""
        sizes = _layer_sizes(self.tile, self.dilations)
        if sizes[-1] != tuple(self.tile):
            raise ValueError(f"segment sizes do not end at the tile: {sizes}")
        return sizes


def _blocking(c: int) -> tuple[int, int, int, int]:
    """(R, M, CP, X) of the conv tile core for C channels: voxels a lane
    computes along x in each row, rows a warp computes (d apart in y), the
    weight row stride (C rounded up to 4), and the x extent of one warp's
    chunk (32 R)."""
    r = conv.voxels_per_lane(c)
    return r, conv.rows_per_warp(c), -(-c // 4) * 4, 32 * r


def _row_groups(n, d, m):
    """Groups of m rows d apart that cover n rows (csrc/conv_tile.cuh
    ``row_groups``): d for each whole block of m d rows, then min(rest,
    d). Accepts numpy arrays."""
    return n // (m * d) * d + np.minimum(n % (m * d), d)


def _smem_layout(seg: Segment) -> tuple:
    """(params, ping, pong, ring) in floats: what one block of K2 holds in
    shared memory. params is every layer's weights (row stride C rounded
    up to 4), then its bias, scale and offset (3 C rounded up to 4), then
    the head's weights and bias when fused (rounded up to 4); ping and
    pong hold the hidden layers' outputs (even and odd layers before the
    last) at channel stride C | 1, rounded up to 4; ring is the first
    layer's staging, two slots for each warp that has rows of its output
    region (at most 4), each ceil4((t_x + 2 min(d, t_x)) (Cin | 1)) + 4
    floats, t_x the region's x extent up to 32 R. The last layer's output
    goes straight to device memory. Accepts numpy tiles."""
    c, k = seg.channels, len(seg.dilations)
    _, m, cp, x_max = _blocking(c)
    params = 27 * seg.cin * cp + 27 * c * cp * (k - 1) + k * _ceil_to(3 * c, 4)
    if seg.fuse_head:
        params += _ceil_to(c * seg.num_classes + seg.num_classes, 4)
    sizes = _layer_sizes(seg.tile, seg.dilations)
    hidden = [_ceil_to(_prod3(s) * (c | 1), 4) for s in sizes[1:k]]
    ping = functools.reduce(np.maximum, hidden[0::2]) if hidden else 0
    pong = functools.reduce(np.maximum, hidden[1::2]) if len(hidden) > 1 else 0
    s, d0 = sizes[1], seg.dilations[0]  # the first layer's output region
    tx = np.minimum(s[2], x_max)
    stagers = np.minimum(WARPS, s[0] * _row_groups(s[1], d0, m) * -(-s[2] // tx))  # warps that have rows of it
    ring = stagers * STAGES * (_ceil_to((tx + 2 * np.minimum(d0, tx)) * (seg.cin | 1), 4) + 4)
    return params, ping, pong, ring


def _segment_smem_bytes(seg: Segment):
    """Shared-memory bytes one block of K2 allocates for ``seg``."""
    return 4 * sum(_smem_layout(seg))


def _segment_hbm_bytes(seg: Segment, vol, batch: int = 1):
    """Modeled device-memory bytes of one segment, the reference's formula
    at fp32: per tile one haloed input window read and the weight stream,
    and the central-region write. The data terms scale with ``batch``; the
    weights are charged once per spatial tile (the batch members of a tile
    are neighbouring blocks). The planner's DP objective and
    ``MegakernelPlan.hbm_bytes`` both call this. Accepts numpy tiles."""
    padded = tuple(_ceil_to(v, t) for v, t in zip(vol, seg.tile))
    ntiles = _prod3(tuple(p // t for p, t in zip(padded, seg.tile)))
    window = _prod3(tuple(t + 2 * seg.halo for t in seg.tile))
    c, k = seg.channels, len(seg.dilations)
    wgt = 27 * seg.cin * c + 27 * c * c * (k - 1)
    if seg.fuse_head:
        wgt += c * seg.num_classes
    data = ntiles * window * seg.cin + _prod3(padded) * seg.cout
    return 4 * (batch * data + ntiles * wgt)


def _segment_device_bytes(seg: Segment, vol, batch: int = 1):
    """Device-memory bytes of one segment's launch as K2 moves them on
    Hopper: the volume read once from the input staging array, the written
    region once, the parameters once. Neighbouring tiles' haloed windows
    overlap; K2 reads a window row by row, and the model takes the rows
    that neighbouring blocks share to come from the 50 MB L2, not from
    device memory (not measured; the reference's formula,
    ``_segment_hbm_bytes``, charges every tile its whole window). Accepts
    numpy tiles."""
    padded = _prod3(tuple(-(-v // t) * t for v, t in zip(vol, seg.tile)))
    c, k = seg.channels, len(seg.dilations)
    n_params = 27 * seg.cin * c + 27 * c * c * (k - 1) + 3 * c * k
    if seg.fuse_head:
        n_params += c * seg.num_classes + seg.num_classes
    return 4 * (batch * (math.prod(vol) * seg.cin + padded * seg.cout) + n_params)


def _input_pad_bytes(first: Segment, vol, batch: int = 1):
    """The copy of the input into the first staging array: read the volume,
    write the padded array."""
    staged = _prod3(tuple(_ceil_to(v, t) + 2 * first.halo for v, t in zip(vol, first.tile)))
    return 4 * batch * first.cin * (math.prod(vol) + staged)


def _segment_macs(seg: Segment, vol, batch: int = 1) -> int:
    """Multiply-adds K2 does for one segment: every layer over its whole
    haloed region in every tile (the halo recompute), then the head."""
    padded = tuple(_ceil_to(v, t) for v, t in zip(vol, seg.tile))
    ntiles = _prod3(tuple(p // t for p, t in zip(padded, seg.tile)))
    sizes = seg.buffer_sizes()
    per_tile = 0
    for i, s in enumerate(sizes[1:]):
        per_tile += _prod3(s) * 27 * (seg.cin if i == 0 else seg.channels) * seg.channels
    if seg.fuse_head:
        per_tile += _prod3(seg.tile) * seg.channels * seg.num_classes
    return batch * ntiles * per_tile


def _ntiles(seg: Segment, vol):
    return _prod3(tuple(-(-v // t) for v, t in zip(vol, seg.tile)))


def _segment_issued_macs(seg: Segment, vol, batch: int = 1):
    """Multiply-adds as K2's warps issue them for one segment: per layer
    the region cut into items of M rows d apart x one chunk of 32 R voxels
    (rows and lanes past the region included), dealt to the block's 4
    warps in rounds (idle warps of the last round included), then the
    fused head over the last layer's items. Accepts numpy tiles."""
    c = seg.channels
    _, m, _, x_max = _blocking(c)
    per_block = 0
    for i, (s, d) in enumerate(zip(_layer_sizes(seg.tile, seg.dilations)[1:], seg.dilations)):
        items = s[0] * _row_groups(s[1], d, m) * -(-s[2] // x_max)
        slots = -(-items // WARPS) * WARPS * m * x_max
        per_block = per_block + slots * 27 * (seg.cin if i == 0 else c) * c
    if seg.fuse_head:
        per_block = per_block + slots * c * seg.num_classes
    return batch * _ntiles(seg, vol) * per_block


def _blocks_per_sm(smem_bytes, channels: int):
    """Blocks of K2 one SM holds, by shared memory, threads and registers.
    Accepts numpy arrays."""
    by_smem = SM_SMEM_BYTES // (smem_bytes + BLOCK_SMEM_RESERVED)
    regs = REGISTERS.get(channels, 255)  # a width K2 is not built for: the most a thread takes
    by_regs = SM_REGISTERS // (_ceil_to(regs, 8) * THREADS)
    return np.minimum(np.minimum(by_smem, min(SM_THREADS // THREADS, by_regs)), 32)


def _wave_quantisation(blocks, per_sm):
    """ceil(waves) / waves for ``blocks`` on the card's SMs at ``per_sm``
    blocks each: the factor by which the last, partial wave stretches a
    launch. Accepts numpy arrays."""
    waves = blocks / (SMS * np.maximum(per_sm, 1))
    return np.ceil(waves) / waves


def _segment_modeled_ms(seg: Segment, vol, batch: int = 1):
    """Modeled device time of one segment's launch (ms): the larger of its
    issued multiply-adds over ``FMA_PER_S`` and its device-memory bytes
    (``_segment_device_bytes``) over ``HBM_BYTES_PER_S``, times the wave
    quantisation of its blocks. The planner's DP objective. Accepts numpy
    tiles."""
    t_ops = _segment_issued_macs(seg, vol, batch) / FMA_PER_S
    t_bytes = _segment_device_bytes(seg, vol, batch) / HBM_BYTES_PER_S
    q = _wave_quantisation(batch * _ntiles(seg, vol), _blocks_per_sm(_segment_smem_bytes(seg), seg.channels))
    return 1e3 * q * np.maximum(t_ops, t_bytes)


def _input_pad_ms(first: Segment, vol, batch: int = 1):
    """Modeled time of the input's copy into the first staging array."""
    return 1e3 * _input_pad_bytes(first, vol, batch) / HBM_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class MegakernelPlan:
    """Static execution plan: segments + geometry for one (cfg, volume)."""

    segments: tuple[Segment, ...]
    vol: tuple[int, int, int]  # true volume dims (pre-padding)

    def padded(self, seg: Segment) -> tuple[int, int, int]:
        """Tile-multiple dims of the region this segment computes."""
        return tuple(_ceil_to(v, t) for v, t in zip(self.vol, seg.tile))

    def out_dims(self, i: int) -> tuple[int, int, int]:
        """Spatial dims of segment i's output array: sized for the next
        segment's reads, the larger of both segments' padded extents plus
        the next halo per side (a border that is never written)."""
        cur = self.padded(self.segments[i])
        if i + 1 == len(self.segments):
            return cur
        nxt = self.segments[i + 1]
        return tuple(max(c, p) + 2 * nxt.halo for c, p in zip(cur, self.padded(nxt)))

    def out_halo(self, i: int) -> int:
        """Offset of segment i's written region in its output array."""
        return self.segments[i + 1].halo if i + 1 < len(self.segments) else 0

    def segment_hbm_bytes(self, i: int, batch: int = 1) -> int:
        """Modeled device-memory bytes of segment i's launch."""
        return _segment_hbm_bytes(self.segments[i], self.vol, batch)

    def segment_operations(self, i: int, batch: int = 1) -> int:
        """Multiply-adds of segment i's launch, its halo recompute included."""
        return _segment_macs(self.segments[i], self.vol, batch)

    def hbm_bytes(self, batch: int = 1) -> int:
        """Modeled device-memory bytes of one forward: the input's copy into
        the first staging array, then every segment's window reads, weight
        streams and writes. The planner minimises this same sum."""
        total = _input_pad_bytes(self.segments[0], self.vol, batch)
        return total + sum(self.segment_hbm_bytes(i, batch) for i in range(len(self.segments)))

    def operations(self, batch: int = 1) -> int:
        """Multiply-adds of one forward through K2, halo recompute and the
        fused head included (each is 2 floating-point operations)."""
        return sum(self.segment_operations(i, batch) for i in range(len(self.segments)))

    def segment_blocks(self, i: int, batch: int = 1) -> int:
        """Blocks of segment i's launch: one per (tile, batch member)."""
        return batch * _ntiles(self.segments[i], self.vol)

    def segment_waves(self, i: int, batch: int = 1) -> float:
        """Waves of segment i's blocks on the card's SMs."""
        seg = self.segments[i]
        per_sm = int(_blocks_per_sm(_segment_smem_bytes(seg), seg.channels))
        return self.segment_blocks(i, batch) / (SMS * per_sm)

    def segment_modeled_ms(self, i: int, batch: int = 1) -> float:
        """Modeled device time of segment i's launch (ms)."""
        return float(_segment_modeled_ms(self.segments[i], self.vol, batch))

    def modeled_ms(self, batch: int = 1) -> float:
        """Modeled device time of one forward (ms): the input's copy into
        the first staging array, then every segment's launch. The planner
        minimises this same sum."""
        total = float(_input_pad_ms(self.segments[0], self.vol, batch))
        return total + sum(self.segment_modeled_ms(i, batch) for i in range(len(self.segments)))


def _axis_candidates(v: int) -> list[int]:
    """Tiles for an axis of extent v: every candidate below v and the
    smallest one at or above it (larger tiles only add padding)."""
    below = [t for t in TILE_CANDIDATES if t < v]
    above = [t for t in TILE_CANDIDATES if t >= v]
    return below + above[:1]


def plan(
    dilations: Sequence[int],
    in_channels: int,
    channels: int,
    num_classes: int,
    vol: tuple[int, int, int],
    *,
    smem_budget: int = SMEM_BUDGET,
    precision: str = "fp32",
    batch: int = 1,
) -> MegakernelPlan:
    """Choose segment boundaries and per-axis tiles by DP over the modeled
    device-memory bytes, subject to every segment's shared memory fitting
    ``smem_budget``. Only fp32 is ported: another policy raises
    ``PrecisionNotPorted``. Raises ValueError naming the layer that cannot
    fit, even alone. Memoised: the serving path plans the same (model,
    volume) for the byte model and for the forward."""
    require_fp32(precision)
    return _plan_cached(
        tuple(int(d) for d in dilations),
        int(in_channels),
        int(channels),
        int(num_classes),
        tuple(int(v) for v in vol),
        int(smem_budget),
        int(batch),
    )


def plan_for_config(
    cfg,
    vol: tuple[int, int, int],
    *,
    smem_budget: int = SMEM_BUDGET,
    precision: str = "fp32",
    batch: int = 1,
) -> MegakernelPlan:
    """``plan`` from a MeshNetConfig-shaped object."""
    return plan(
        cfg.dilations,
        cfg.in_channels,
        cfg.channels,
        cfg.num_classes,
        vol,
        smem_budget=smem_budget,
        precision=precision,
        batch=batch,
    )


def _dp(dils, in_channels, channels, num_classes, vol, smem_budget, batch):
    """(least modeled ms, segments) over every split of the schedule into
    segments and every tile of each. A segment's time does not depend on
    the other segments, so best[i], the least time of layers i.., is the
    minimum over j of segment (i, j)'s fastest fitting tile plus best[j];
    each segment's time and shared memory are evaluated over the whole
    tile grid at once. Among tiles of equal time the one with the fewest
    modeled bytes wins."""
    n = len(dils)
    grids = tuple(np.meshgrid(*[np.array(_axis_candidates(v), np.int64) for v in vol], indexing="ij"))
    inf = float("inf")
    best = [inf] * n + [0.0]
    choice: list = [None] * n

    def seg_for(i, j, tile):
        return Segment(
            start=i,
            dilations=dils[i:j],
            cin=in_channels if i == 0 else channels,
            channels=channels,
            tile=tile,
            fuse_head=j == n,
            num_classes=num_classes,
        )

    for i in range(n - 1, -1, -1):
        for j in range(i + 1, min(n, i + MAX_LAYERS) + 1):
            seg = seg_for(i, j, grids)
            ms = _segment_modeled_ms(seg, vol, batch)
            if i == 0:
                ms = ms + _input_pad_ms(seg, vol, batch)
            cost = np.where(_segment_smem_bytes(seg) <= smem_budget, ms, inf).reshape(-1)
            least = float(cost.min())
            if least == inf:
                continue
            ties = np.flatnonzero(cost <= least * (1 + 1e-12))
            hbm = np.broadcast_to(_segment_hbm_bytes(seg, vol, batch), grids[0].shape).reshape(-1)
            flat = int(ties[np.argmin(hbm[ties])])
            c = float(cost[flat]) + best[j]
            if c < best[i]:
                best[i] = c
                choice[i] = (j, tuple(int(g.reshape(-1)[flat]) for g in grids))
    if best[0] == inf:
        return inf, None
    segments, i = [], 0
    while i < n:
        j, tile = choice[i]
        segments.append(seg_for(i, j, tile))
        i = j
    return best[0], tuple(segments)


@functools.lru_cache(maxsize=256)
def _plan_cached(dils, in_channels, channels, num_classes, vol, smem_budget, batch) -> MegakernelPlan:
    _, segments = _dp(dils, in_channels, channels, num_classes, vol, smem_budget, batch)
    if segments is None:
        # Every layer alone is a valid segment, and a one-layer segment
        # holds only its parameters on chip, whatever its tile: so some
        # layer's parameters alone exceed the budget. Name the largest.
        n = len(dils)
        needs = []
        for i in range(n):
            seg = Segment(i, dils[i : i + 1], in_channels if i == 0 else channels, channels,
                          (TILE_CANDIDATES[0],) * 3, i == n - 1, num_classes)
            needs.append((_segment_smem_bytes(seg), -i, seg))
        need, _, seg = max(needs)
        head = ", fused head" if seg.fuse_head else ""
        raise ValueError(
            f"megakernel plan infeasible: layer {seg.start} (dilation {seg.dilations[0]}, "
            f"{seg.cin} -> {channels} channels{head}) at tile {seg.tile} needs {need} bytes "
            f"of shared memory, over the {smem_budget}-byte budget; reduce the channel "
            f"width or raise smem_budget"
        )
    return MegakernelPlan(segments=segments, vol=vol)


# ------------------------------------------------------------------ K2 ---


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("megakernel")
        fn = lib.repro_megakernel_segment_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_megakernel_supports.argtypes = [ctypes.c_int]
        lib.repro_megakernel_supports.restype = ctypes.c_int
        lib.repro_megakernel_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.repro_megakernel_blocks_per_sm.restype = ctypes.c_int
        lib.repro_megakernel_error_string.argtypes = [ctypes.c_int]
        lib.repro_megakernel_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_operands(x, pln: MegakernelPlan, i: int, layers, head):
    seg = pln.segments[i]
    if x.ndim != 5 or x.shape[-1] != seg.cin:
        raise ValueError(f"x must be (B, Z, Y, X, {seg.cin}), got shape {tuple(x.shape)}")
    need = tuple(v + seg.halo for v in pln.vol)
    if any(s < n for s, n in zip(x.shape[1:4], need)):
        raise ValueError(f"staging array {tuple(x.shape[1:4])} too small for the volume at offset {seg.halo}: needs {need}")
    if len(layers) != len(seg.dilations):
        raise ValueError(f"segment has {len(seg.dilations)} layers, got {len(layers)}")
    c = seg.channels
    for li, (w, b, s, o) in enumerate(layers):
        cin = seg.cin if li == 0 else c
        if tuple(w.shape) != (3, 3, 3, cin, c):
            raise ValueError(f"layer {li}: w must be (3, 3, 3, {cin}, {c}), got {tuple(w.shape)}")
        for name, t in (("b", b), ("scale", s), ("offset", o)):
            if tuple(t.shape) != (c,):
                raise ValueError(f"layer {li}: {name} must be ({c},), got {tuple(t.shape)}")
    if seg.fuse_head != (head is not None):
        raise ValueError("the head is given exactly when the segment fuses it")
    if head is not None and (
        tuple(head[0].shape) != (c, seg.num_classes) or tuple(head[1].shape) != (seg.num_classes,)
    ):
        raise ValueError(f"head must be ({c}, {seg.num_classes}) and ({seg.num_classes},)")


def blocks_per_sm(seg: Segment) -> int:
    """Blocks of ``seg`` one SM holds, from the built K2 (the runtime's
    occupancy calculator), against which ``_blocks_per_sm`` models it. On
    the card only."""
    return int(_kernel().repro_megakernel_blocks_per_sm(seg.channels, seg.cin, int(_segment_smem_bytes(seg))))


def geometry(x_shape: tuple, pln: MegakernelPlan, i: int) -> list[int]:
    """The geometry array K2's entry point takes for segment ``i`` of
    ``pln`` on an input staging array of shape ``x_shape``: B, cin, C, k,
    classes (0 without the head), vol, tile, the input's dims and halo,
    the output's dims and halo, the shared-memory layout (params, ping,
    pong, ring floats; K2 checks it against its own), then the
    dilations."""
    seg = pln.segments[i]
    return [
        x_shape[0], seg.cin, seg.channels, len(seg.dilations), seg.num_classes if seg.fuse_head else 0,
        *pln.vol, *seg.tile, *x_shape[1:4], seg.halo, *pln.out_dims(i), pln.out_halo(i),
        *(int(v) for v in _smem_layout(seg)), *seg.dilations,
    ]


def run_segment(
    x: torch.Tensor,
    pln: MegakernelPlan,
    i: int,
    layers: Sequence[tuple],
    head: Optional[tuple] = None,
) -> torch.Tensor:
    """Segment ``i`` of ``pln`` on the staging array ``x``: (B, Z, Y, X,
    cin) holding the volume at offset ``segments[i].halo`` (its border is
    never read). ``layers`` gives each layer's (w, b, scale, offset), the
    folded BatchNorm in scale and offset; ``head`` the fused head's (w (C,
    classes), b) when the segment fuses it. Returns the output staging
    array (B, *pln.out_dims(i), cout) whose region [out_halo(i), out_halo(i)
    + padded) is written and whose border is not.

    On CUDA every tensor must be contiguous fp32 on x's device, the width
    one the kernel is instantiated for (5, 10, 18, 21), and the segment's
    shared memory within one block."""
    global launches
    _check_operands(x, pln, i, layers, head)
    if x.device.type == "cpu":
        return ref.megakernel_segment(x, pln, i, layers, head)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    tensors = [x] + [t for layer in layers for t in layer] + list(head or ())
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    seg = pln.segments[i]
    lib = _kernel()
    if not lib.repro_megakernel_supports(seg.channels):
        raise ValueError(f"the CUDA kernel is not instantiated for Cout={seg.channels}")
    if len(seg.dilations) > MAX_LAYERS:
        raise ValueError(f"a segment holds at most {MAX_LAYERS} layers, got {len(seg.dilations)}")
    smem = _segment_smem_bytes(seg)
    if smem > SMEM_BUDGET:
        raise ValueError(f"segment {i} needs {smem} bytes of shared memory, over the {SMEM_BUDGET} one block can use")
    params = torch.cat([t.reshape(-1) for t in tensors[1:]])
    out = torch.empty((x.shape[0],) + pln.out_dims(i) + (seg.cout,), dtype=torch.float32, device=x.device)
    geom = geometry(tuple(x.shape), pln, i)
    geom_c = (ctypes.c_int * len(geom))(*geom)
    err = lib.repro_megakernel_segment_f32(
        x.data_ptr(), params.data_ptr(), out.data_ptr(), geom_c, len(geom),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: {lib.repro_megakernel_error_string(err).decode()}")
    launches += 1
    return out
