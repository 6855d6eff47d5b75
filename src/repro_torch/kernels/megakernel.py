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

At the bf16 and int8w policies a plan is made at the policy's per-role
byte widths (``plan_widths``: activations, weights, input, staging) and
runs K2r (``csrc/megakernel_lp.cu``): the same segment with bf16 or int8
staging arrays, bf16 or int8 weights widened to fp32 in shared memory,
fp32 accumulation, one round to bf16 after every layer, and, under int8w
with staging scales, the first layer's taps dequantised per channel
(``deq``) and the last layer's output quantised to int8 (``qscale``).
Such an int8 crossing adds up to half an int8 step of error to every
activation, so the reference's result depends on where its plan puts
them. A plan with int8 staging therefore stages int8 at the boundaries
the reference's plan has at that volume (``_reference_starts``, a copy of
its VMEM planner's choice) and bf16, which the reference's segments round
to after every layer anyway, at the others; its own boundaries are still
priced by time, and no segment spans one of the reference's.
K2r computes its products on the bf16 tensor cores (``mma.sync``
m16n8k16) and stages its input rows by 16-byte asynchronous copies, so
every staging array it reads or writes has its own layout
(``staging_empty``: bf16 positions of several channels padded to 8
channels, other x rows' pitch padded to 16 bytes; the logical tensor is
the same). Only the card's path allocates it: the plain version reads
any layout and returns contiguous arrays. Its layout in shared memory (``_smem_layout`` at reduced
widths: the weights in fragment order, the copy rings, the A buffers and
row buffers, bf16 ping and pong), its register table (``REGISTERS_LP``)
and its time model (``_lp_segment_work``: its input rows, (row, tap row)
pairs and blocks, measured; its tensor-core MACs; against the bytes) are
its own.

K2z (and K2r-z) is the same kernel with a narrower valid Z interval,
``run_segment(..., z_bounds=(z_lo, z_hi))``, the reference's
``has_z_bounds``: the sharded executor (core/spatial_shard.py) runs each
slab's window of slab + 2 x the receptive-field radius and places the true
volume's Z edges inside it. The bounds travel in the geometry array, so
no window depth or bound needs a build of its own. ``band=(lo, hi)``
narrows the rows a launch writes: the grid covers only the Z tiles that
meet the band, the input rows outside it widened by the segment's halo
are never read, and the output rows outside it are left unwritten
(``ops.meshnet_apply_megakernel(..., rows=)`` gives each segment of a
window the band its successors read).

A CUDA tensor launches K2 (K2r) or raises; a CPU tensor takes the plain
version (``kernels/ref.py::megakernel_segment``). ``launches`` counts
K2's launches, ``reduced_launches`` K2r's and ``z_launches`` those with
``z_bounds``, and nothing else.
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


#: per-role byte widths of a plan: (activations and logits, conv weights,
#: the input volume, the inter-segment staging arrays).
Widths = tuple[int, int, int, int]
FP32_WIDTHS: Widths = (4, 4, 4, 4)
_DTYPE_OF_WIDTH = {4: torch.float32, 2: torch.bfloat16, 1: torch.int8}


def plan_widths(precision: str, int8_staging: Optional[bool] = None) -> Widths:
    """The (act, weight, input, staging) byte widths a plan prices at
    ``precision`` (the reference's ``plan_widths``): int8w stages int8 only
    when staging scales exist (BatchNorm statistics or a calibration
    pass), else at the bf16 activation width."""
    stg = quantize.staging_bytes(precision)
    if precision == "int8w" and int8_staging is False:
        stg = quantize.act_bytes(precision)
    return (quantize.act_bytes(precision), quantize.weight_bytes(precision), quantize.input_bytes(precision), stg)

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
REGISTERS = {5: 226, 10: 222, 18: 204, 21: 228}
#: the same for K2r (csrc/megakernel_lp.cu, 4 blocks an SM by its launch
#: bounds, no spill), the most over its bf16 and int8 input instantiations.
REGISTERS_LP = {5: 128, 10: 128, 18: 127, 21: 128}
SM_REGISTERS = 65_536

#: K2r's ring (csrc/megakernel_lp.cu): each warp keeps LP_STAGES input
#: rows in flight (its items: ``_lp_blocking``).
LP_STAGES = 3
#: the card's bf16 dense tensor-core rate (NVIDIA's data sheet, 989
#: TFLOP/s, two operations a MAC).
TC_MACS_PER_S = 989e12 / 2
#: K2r's time in seconds of one SM for each input row an item reads (its
#: copy and A operands) and for each (output row, tap row) pair it
#: multiplies over its NX voxels (the pair's mmas, B fragments and share
#: of the epilogue): its time follows these, not its MACs. Fit on an
#: NVIDIA H100 80GB HBM3 at 700 W (SM clock 1980 MHz) to 5 -> 5 bf16 layers
#: at d = 2, 8 and 16 over 256^3 with items of 4 rows (1.18M rows, 2.36M
#: pairs a layer: 1.32-1.35 ms) and of 2 rows (1.57M rows, the same pairs:
#: 1.42-1.46 ms), one wave of 4 blocks an SM (tools/k2r_variants.py);
#: and for each block (its weights' staging, its ring's fill and drain):
#: 11,008 blocks of (4, 6, 64) at d = 2 took 1.83 ms, 0.36 ms over rows
#: and pairs.
LP_ROW_S = 25e-9
LP_PAIR_S = 62e-9
LP_BLOCK_S = 4.3e-6

#: kernel launches since the counter was last reset (CPU calls don't
#: count): K2's, K2r's, and those of either with ``z_bounds`` (K2z and
#: K2r-z, the sharded executor's windows), which count only here.
launches = 0
reduced_launches = 0
z_launches = 0

_LIB = None
_LIB_LP = None


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


def _lp_blocking(c: int) -> tuple[int, int, int, int]:
    """(M, MT, NT, NX) of K2r for C channels: output rows a warp's item
    holds (d apart in y), m16 tiles along x, n8 tiles of channels, and the
    item's x extent (16 MT voxels)."""
    mt = 4 if c <= 8 else 2 if c <= 16 else 1
    return (2 if c <= 8 else 3 if c <= 16 else 4), mt, -(-c // 8), 16 * mt


def _pos_bytes(cin: int) -> int:
    """Bytes a position takes in K2r's A layout: its channels as bf16 in
    groups of 8 (16 bytes), an odd number of groups."""
    return (-(-cin // 8) | 1) * 16


def _ksteps(cin: int) -> int:
    """k16 steps of one input row in K2r's implicit GEMM: its three x taps
    times ``cin`` channels in groups of 8, two groups a step."""
    return (3 * -(-cin // 8) + 1) // 2


def _smem_layout_lp(seg: Segment, widths: Widths, stage=None) -> tuple:
    """(params, ping, pong, ring) in floats (4 bytes; every part a multiple
    of 16 bytes) of one block of K2r (csrc/megakernel_lp.cu, which checks
    every launch against it), its input and output staging arrays at the
    widths ``widths`` and ``stage`` give. params: 16 zero bytes, then per
    layer its weights as bf16 B fragments of m16n8k16 (9 tap rows x k16
    steps x n8 tiles x 256 bytes; twice for the first layer of a segment
    that dequantises its int8 input: the hi and lo halves of its weights
    times the scales), its A-offset table (8 bytes a k16 step, rounded up
    to 16) and its bias, scale and offset (3 C floats); then the head's
    fragments (k16 steps of C x n8 tiles of the classes) and bias, and the
    dequant and quantisation scales (cin and C floats). ping and pong: the
    hidden layers' outputs, bf16 in the A layout (``_pos_bytes(C)`` a
    position). ring: for each of the 4 warps, LP_STAGES slots of one input
    row span of X + 2 d positions (copied position by position into the A
    layout from a bf16 staging array of several channels; else as packed
    bytes, (X + 2 d) cin 2 rounded up to 16, + 32 for the alignment of its
    ends, then laid out in an A buffer of X + 2 d positions), and an output
    row buffer (X' cout 2 bytes rounded up to 16, + 16) where the output is
    int8 or the head's logits; X is the first layer's region x extent and
    X' the tile's, each at most NX. Accepts numpy tiles."""
    c, k = seg.channels, len(seg.dilations)
    _, _, nt, nx = _lp_blocking(c)
    stage = STAGED if stage is None else stage
    ib, ob = _in_out_widths(seg, widths, stage)
    deq = _dequantises(seg, widths, stage)
    params = 16
    for li in range(k):
        ks = _ksteps(seg.cin if li == 0 else c)
        params += 9 * ks * nt * 256 * (2 if li == 0 and deq else 1) + _ceil_to(8 * ks, 16) + _ceil_to(12 * c, 16)
    if seg.fuse_head:
        params += -(-nt // 2) * -(-seg.num_classes // 8) * 256 + _ceil_to(4 * seg.num_classes, 16)
    params += _ceil_to(4 * seg.cin, 16) + _ceil_to(4 * c, 16)
    sizes = _layer_sizes(seg.tile, seg.dilations)
    hidden = [_prod3(s) * _pos_bytes(c) for s in sizes[1:k]]
    ping = functools.reduce(np.maximum, hidden[0::2]) if hidden else 0
    pong = functools.reduce(np.maximum, hidden[1::2]) if len(hidden) > 1 else 0
    span = np.minimum(sizes[1][2], nx) + 2 * seg.dilations[0]
    if ib == 2 and seg.cin > 1:  # copied straight into the A layout
        slot, abuf = span * _pos_bytes(seg.cin), 0
    else:
        slot, abuf = _ceil_to(span * seg.cin * 2, 16) + 32, span * _pos_bytes(seg.cin)
    out = _ceil_to(np.minimum(seg.tile[2], nx) * seg.cout * 2, 16) + 16 if (seg.fuse_head or ob == 1) else 0
    ring = WARPS * (LP_STAGES * slot + abuf + out)
    return params // 4, ping // 4, pong // 4, ring // 4


def _smem_layout(seg: Segment, widths: Widths = FP32_WIDTHS, stage=None) -> tuple:
    """(params, ping, pong, ring) in floats: what one block of K2 (K2r at
    reduced ``widths``: ``_smem_layout_lp``, its staging arrays as
    ``stage`` says) holds in shared memory. params is every layer's
    weights as fp32 (row stride C rounded up to 4), then its bias, scale
    and offset (3 C rounded up to 4), then the head's weights and bias when
    fused (rounded up to 4); ping and pong hold the hidden layers' outputs
    as fp32 (even and odd layers before the last) at channel stride C | 1,
    rounded up to 4; ring is K2's first-layer staging, two slots for each
    warp that has rows of its output region (at most 4), each
    ceil4((t_x + 2 min(d, t_x)) (Cin | 1)) + 4 floats, t_x the region's x
    extent up to 32 R. The last layer's output goes straight to device
    memory. Accepts numpy tiles."""
    if widths != FP32_WIDTHS:
        return _smem_layout_lp(seg, widths, stage)
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


def _segment_smem_bytes(seg: Segment, widths: Widths = FP32_WIDTHS, stage=None):
    """Shared-memory bytes one block of K2 (K2r) allocates for ``seg``."""
    return 4 * sum(_smem_layout(seg, widths, stage))


#: whether a segment's input and output staging arrays are at the plan's
#: staging width (else at its activation width; ``MegakernelPlan.int8_at``).
Stage = tuple[bool, bool]
STAGED: Stage = (True, True)


def _dequantises(seg: Segment, widths: Widths, stage: Stage = STAGED) -> bool:
    """Whether K2r's first layer dequantises an int8 staging array (a
    later segment reading int8; ``scale_operands``' deq)."""
    return widths != FP32_WIDTHS and seg.start > 0 and _in_out_widths(seg, widths, stage)[0] == 1


def _in_out_widths(seg: Segment, widths: Widths, stage: Stage = STAGED) -> tuple[int, int]:
    """Bytes an element of the segment's input and output staging arrays:
    the input volume's width for the first segment, else the staging width
    where ``stage`` says so and the activation width where not; the
    activation width for the fused head's logits, else the same rule."""
    act, _, inp, stg = widths
    return (inp if seg.start == 0 else stg if stage[0] else act), (
        act if seg.fuse_head else stg if stage[1] else act)


def _segment_hbm_bytes(seg: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS, stage: Stage = STAGED):
    """Modeled device-memory bytes of one segment, the reference's formula
    (its ``_segment_hbm_bytes``) at the per-role ``widths``: per tile one
    haloed input window read at the input or staging width and the weight
    stream at the weight width, and the central-region write at the
    staging width (the activation width for the fused head's logits). The
    data terms scale with ``batch``; the weights are charged once per
    spatial tile (the batch members of a tile are neighbouring blocks).
    The planner's tie-break and ``MegakernelPlan.hbm_bytes`` both call
    this. Accepts numpy tiles."""
    _, wt, _, _ = widths
    ib, ob = _in_out_widths(seg, widths, stage)
    padded = tuple(_ceil_to(v, t) for v, t in zip(vol, seg.tile))
    ntiles = _prod3(tuple(p // t for p, t in zip(padded, seg.tile)))
    window = _prod3(tuple(t + 2 * seg.halo for t in seg.tile))
    c, k = seg.channels, len(seg.dilations)
    wgt = 27 * seg.cin * c + 27 * c * c * (k - 1)
    if seg.fuse_head:
        wgt += c * seg.num_classes
    data = ntiles * window * seg.cin * ib + _prod3(padded) * seg.cout * ob
    return batch * data + ntiles * wgt * wt


def _segment_device_bytes(seg: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS, stage: Stage = STAGED):
    """Device-memory bytes of one segment's launch as K2 (K2r) moves them
    on Hopper: the volume read once from the input staging array, the
    written region once, each at its role's width, the parameters once
    (conv weights at the weight width, the head's at the activation width,
    bias, scale, offset and K2r's dequant and quantisation scales fp32).
    Neighbouring tiles' haloed windows overlap; the kernel reads a window
    row by row, and the model takes the rows that neighbouring blocks
    share to come from the 50 MB L2, not from device memory (not measured;
    the reference's formula, ``_segment_hbm_bytes``, charges every tile
    its whole window). Accepts numpy tiles."""
    act, wt, _, _ = widths
    ib, ob = _in_out_widths(seg, widths, stage)
    padded = _prod3(tuple(-(-v // t) * t for v, t in zip(vol, seg.tile)))
    c, k = seg.channels, len(seg.dilations)
    weights = (27 * seg.cin * c + 27 * c * c * (k - 1)) * wt
    vectors = 3 * c * k
    if seg.fuse_head:
        weights += c * seg.num_classes * act
        vectors += seg.num_classes
    if widths != FP32_WIDTHS:
        vectors += seg.cin + c
    data = math.prod(vol) * seg.cin * ib + padded * seg.cout * ob
    return batch * data + weights + 4 * vectors


def _input_pad_bytes(first: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS):
    """The copy of the input into the first staging array: read the volume,
    write the padded array, at the input's width."""
    staged = _prod3(tuple(_ceil_to(v, t) + 2 * first.halo for v, t in zip(vol, first.tile)))
    return widths[2] * batch * first.cin * (math.prod(vol) + staged)


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


def _segment_issued_macs(seg: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS, stage: Stage = STAGED):
    """Multiply-adds as K2's warps issue them for one segment: per layer
    the region cut into items of M rows d apart x one chunk of 32 R voxels
    (rows and lanes past the region included), dealt to the block's 4
    warps in rounds (idle warps of the last round included), then the
    fused head over the last layer's items. At reduced ``widths``, K2r's
    padded tensor-core MACs (``_lp_segment_work``). Accepts numpy
    tiles."""
    if widths != FP32_WIDTHS:
        return _lp_segment_work(seg, vol, batch, widths, stage)[0]
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


def _lp_segment_work(seg: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS, stage: Stage = STAGED):
    """(tensor-core MACs, input rows read, (output row, tap row) pairs) of
    K2r for one segment, as csrc/megakernel_lp.cu deals its work: per
    layer, items of up to M output rows d apart in y (only the rows inside
    the region) x NX voxels along x (lanes past the region included), each
    item reading 3 (rows + 2) input rows, and every pair issuing k16 steps
    x n8 tiles x m16 tiles of m16n8k16 (2048 MACs each), the first layer's
    twice over when it dequantises int8 staging (hi and lo weights); the
    head one product of k16 steps x n8 tiles of classes a (row, m16 tile).
    The items are dealt to 4 warps in rounds (idle warps of the last round
    included). Accepts numpy tiles."""
    c = seg.channels
    m, mt, nt, nx = _lp_blocking(c)
    deq = _dequantises(seg, widths, stage)
    macs = rows = pairs = 0
    for i, (s, d) in enumerate(zip(_layer_sizes(seg.tile, seg.dilations)[1:], seg.dilations)):
        ks = _ksteps(seg.cin if i == 0 else c)
        groups = _row_groups(s[1], d, m)
        nch = -(-s[2] // nx)
        items = s[0] * groups * nch
        deal = -(-items // WARPS) * WARPS / items  # the last round's idle warps
        layer_pairs = deal * s[0] * s[1] * nch * 9
        macs = macs + layer_pairs * ks * nt * mt * (2 if (i == 0 and deq) else 1) * 2048
        rows = rows + deal * s[0] * nch * 3 * (s[1] + 2 * groups)
        pairs = pairs + layer_pairs
    if seg.fuse_head:
        macs = macs + seg.tile[0] * seg.tile[1] * -(-seg.tile[2] // nx) * mt * -(-nt // 2) * -(
            -seg.num_classes // 8) * 2048
    n = batch * _ntiles(seg, vol)
    return n * macs, n * rows, n * pairs


def _blocks_per_sm(smem_bytes, channels: int, widths: Widths = FP32_WIDTHS):
    """Blocks of K2 (K2r) one SM holds, by shared memory, threads and
    registers. Accepts numpy arrays."""
    by_smem = SM_SMEM_BYTES // (smem_bytes + BLOCK_SMEM_RESERVED)
    table = REGISTERS if widths == FP32_WIDTHS else REGISTERS_LP
    regs = table.get(channels, 255)  # a width the kernel is not built for: the most a thread takes
    by_regs = SM_REGISTERS // (_ceil_to(regs, 8) * THREADS)
    return np.minimum(np.minimum(by_smem, min(SM_THREADS // THREADS, by_regs)), 32)


def _wave_quantisation(blocks, per_sm):
    """ceil(waves) / waves for ``blocks`` on the card's SMs at ``per_sm``
    blocks each: the factor by which the last, partial wave stretches a
    launch. Accepts numpy arrays."""
    waves = blocks / (SMS * np.maximum(per_sm, 1))
    return np.ceil(waves) / waves


def _segment_modeled_ms(seg: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS, stage: Stage = STAGED):
    """Modeled device time of one segment's launch (ms): the larger of its
    issued multiply-adds over ``FMA_PER_S`` (K2r: its tensor-core MACs
    over ``TC_MACS_PER_S`` or its input rows, (output row, tap row) pairs
    and blocks at ``LP_ROW_S``, ``LP_PAIR_S`` and ``LP_BLOCK_S`` over the
    SMs, the larger) and its device-memory bytes
    (``_segment_device_bytes``) over ``HBM_BYTES_PER_S``, times the wave
    quantisation of its blocks. The planner's DP objective. Accepts numpy
    tiles."""
    if widths == FP32_WIDTHS:
        t_ops = _segment_issued_macs(seg, vol, batch, widths) / FMA_PER_S
    else:
        macs, rows, pairs = _lp_segment_work(seg, vol, batch, widths, stage)
        blocks = batch * _ntiles(seg, vol)
        t_ops = np.maximum(macs / TC_MACS_PER_S, (rows * LP_ROW_S + pairs * LP_PAIR_S + blocks * LP_BLOCK_S) / SMS)
    t_bytes = _segment_device_bytes(seg, vol, batch, widths, stage) / HBM_BYTES_PER_S
    per_sm = _blocks_per_sm(_segment_smem_bytes(seg, widths, stage), seg.channels, widths)
    q = _wave_quantisation(batch * _ntiles(seg, vol), per_sm)
    return 1e3 * q * np.maximum(t_ops, t_bytes)


def _input_pad_ms(first: Segment, vol, batch: int = 1, widths: Widths = FP32_WIDTHS):
    """Modeled time of the input's copy into the first staging array."""
    return 1e3 * _input_pad_bytes(first, vol, batch, widths) / HBM_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class MegakernelPlan:
    """Static execution plan: segments + geometry for one (cfg, volume),
    priced at ``widths`` (fp32 runs K2, reduced widths K2r)."""

    segments: tuple[Segment, ...]
    vol: tuple[int, int, int]  # true volume dims (pre-padding)
    widths: Widths = FP32_WIDTHS
    #: the layers before which the plan stages at its staging width (int8
    #: under int8w with staging scales: the reference plan's boundaries);
    #: its other boundaries stage at the activation width. None: all do.
    int8_at: Optional[frozenset] = None

    def stage(self, i: int) -> Stage:
        """Whether segment i's input and output staging arrays are at the
        plan's staging width (else at its activation width)."""
        if self.int8_at is None:
            return STAGED
        seg = self.segments[i]
        return seg.start in self.int8_at, seg.start + len(seg.dilations) in self.int8_at

    @property
    def crossings(self) -> int:
        """Segment boundaries at which the activations are staged as int8:
        quantised by one segment and dequantised by the next."""
        return sum(self.dtypes(i)[0] == torch.int8 for i in range(1, len(self.segments)))

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

    def dtypes(self, i: int) -> tuple[torch.dtype, torch.dtype]:
        """dtypes of segment i's input and output staging arrays."""
        return tuple(_DTYPE_OF_WIDTH[w] for w in _in_out_widths(self.segments[i], self.widths, self.stage(i)))

    def segment_hbm_bytes(self, i: int, batch: int = 1) -> int:
        """Modeled device-memory bytes of segment i's launch."""
        return _segment_hbm_bytes(self.segments[i], self.vol, batch, self.widths, self.stage(i))

    def segment_operations(self, i: int, batch: int = 1) -> int:
        """Multiply-adds of segment i's launch, its halo recompute included."""
        return _segment_macs(self.segments[i], self.vol, batch)

    def hbm_bytes(self, batch: int = 1) -> int:
        """Modeled device-memory bytes of one forward: the input's copy into
        the first staging array, then every segment's window reads, weight
        streams and writes, each role at the plan's width (the reference's
        ``MegakernelPlan.hbm_bytes``)."""
        total = _input_pad_bytes(self.segments[0], self.vol, batch, self.widths)
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
        per_sm = int(_blocks_per_sm(_segment_smem_bytes(seg, self.widths, self.stage(i)), seg.channels, self.widths))
        return self.segment_blocks(i, batch) / (SMS * per_sm)

    def segment_issued_macs(self, i: int, batch: int = 1) -> float:
        """Multiply-adds segment i's launch issues: K2's fp32 FMAs, or K2r's
        padded tensor-core MACs (``_lp_segment_work``)."""
        return float(_segment_issued_macs(self.segments[i], self.vol, batch, self.widths, self.stage(i)))

    def segment_modeled_ms(self, i: int, batch: int = 1) -> float:
        """Modeled device time of segment i's launch (ms)."""
        return float(_segment_modeled_ms(self.segments[i], self.vol, batch, self.widths, self.stage(i)))

    def modeled_ms(self, batch: int = 1) -> float:
        """Modeled device time of one forward (ms): the input's copy into
        the first staging array, then every segment's launch. The planner
        minimises this same sum."""
        total = float(_input_pad_ms(self.segments[0], self.vol, batch, self.widths))
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
    int8_staging: Optional[bool] = None,
    batch: int = 1,
) -> MegakernelPlan:
    """Choose segment boundaries and per-axis tiles by DP over the modeled
    device time, subject to every segment's shared memory fitting
    ``smem_budget``, at ``precision``'s per-role widths (``plan_widths``;
    ``int8_staging`` matters under int8w only; with int8 staging, the
    reference's boundaries stage int8 and bound the segments, the others
    stage bf16). Raises ValueError naming
    the layer that cannot fit, even alone. Memoised per (model, volume,
    budget, precision, staging, batch): the serving path plans the same
    request for the byte model and for the forward."""
    precision = quantize.validate(precision)
    return _plan_cached(
        tuple(int(d) for d in dilations),
        int(in_channels),
        int(channels),
        int(num_classes),
        tuple(int(v) for v in vol),
        int(smem_budget),
        precision,
        precision == "int8w" and int8_staging is not False,
        int(batch),
    )


def plan_for_config(
    cfg,
    vol: tuple[int, int, int],
    *,
    smem_budget: int = SMEM_BUDGET,
    precision: str = "fp32",
    int8_staging: Optional[bool] = None,
    batch: int = 1,
) -> MegakernelPlan:
    """``plan`` from a MeshNetConfig-shaped object. Under int8w, int8
    staging defaults to whether the config has BatchNorm statistics to
    bound the staging scales with (``quantize.staging_scales_from_bn``)."""
    if int8_staging is None:
        int8_staging = bool(cfg.use_batchnorm)
    return plan(
        cfg.dilations,
        cfg.in_channels,
        cfg.channels,
        cfg.num_classes,
        vol,
        smem_budget=smem_budget,
        precision=precision,
        int8_staging=int8_staging,
        batch=batch,
    )


def _dp(dils, in_channels, channels, num_classes, vol, smem_budget, batch, widths: Widths = FP32_WIDTHS,
        cuts: Optional[frozenset] = None):
    """(least modeled ms, segments) over every split of the schedule into
    segments and every tile of each. A segment's time does not depend on
    the other segments, so best[i], the least time of layers i.., is the
    minimum over j of segment (i, j)'s fastest fitting tile plus best[j];
    each segment's time and shared memory are evaluated over the whole
    tile grid at once. Among tiles of equal time the one with the fewest
    modeled bytes wins. With ``cuts`` (layers), no segment spans one, and a
    boundary stages at the staging width there and at the activation
    width elsewhere (``MegakernelPlan.int8_at``)."""
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
            if cuts is not None and j - 1 in cuts and j - 1 > i:
                break  # segment (i, j) would span the cut at j - 1
            seg = seg_for(i, j, grids)
            stage = STAGED if cuts is None else (i in cuts, j in cuts)
            ms = _segment_modeled_ms(seg, vol, batch, widths, stage)
            if i == 0:
                ms = ms + _input_pad_ms(seg, vol, batch, widths)
            cost = np.where(_segment_smem_bytes(seg, widths, stage) <= smem_budget, ms, inf).reshape(-1)
            least = float(cost.min())
            if least == inf:
                continue
            ties = np.flatnonzero(cost <= least * (1 + 1e-12))
            hbm = np.broadcast_to(_segment_hbm_bytes(seg, vol, batch, widths, stage), grids[0].shape).reshape(-1)
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
def _plan_cached(dils, in_channels, channels, num_classes, vol, smem_budget, precision, int8_staging,
                 batch) -> MegakernelPlan:
    widths = plan_widths(precision, int8_staging)
    cuts = None
    if widths[3] == 1:  # int8 staging: at the reference's boundaries only
        cuts = frozenset(_reference_starts(dils, in_channels, channels, num_classes, vol)[1:])
    _, segments = _dp(dils, in_channels, channels, num_classes, vol, smem_budget, batch, widths, cuts)
    if segments is None:
        # Every layer alone is a valid segment, and a one-layer segment
        # holds only its parameters on chip, whatever its tile: so some
        # layer's parameters alone exceed the budget. Name the largest.
        n = len(dils)
        needs = []
        for i in range(n):
            seg = Segment(i, dils[i : i + 1], in_channels if i == 0 else channels, channels,
                          (TILE_CANDIDATES[0],) * 3, i == n - 1, num_classes)
            needs.append((_segment_smem_bytes(seg, widths), -i, seg))
        need, _, seg = max(needs)
        head = ", fused head" if seg.fuse_head else ""
        raise ValueError(
            f"megakernel plan infeasible: layer {seg.start} (dilation {seg.dilations[0]}, "
            f"{seg.cin} -> {channels} channels{head}) at tile {seg.tile} needs {need} bytes "
            f"of shared memory, over the {smem_budget}-byte budget; reduce the channel "
            f"width or raise smem_budget"
        )
    return MegakernelPlan(segments=segments, vol=vol, widths=widths, int8_at=cuts)


#: the reference's planning budget (16 MiB of TPU VMEM a core less its
#: compiler's headroom) and its tile candidates: what ``_reference_starts``
#: plans with.
REFERENCE_VMEM_BUDGET = 14 * 1024 * 1024
REFERENCE_TILE_CANDIDATES = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 128, 160, 192, 256)


@functools.lru_cache(maxsize=256)
def _reference_starts(dils, in_channels, channels, num_classes, vol) -> tuple[int, ...]:
    """The first layer of every segment of the reference's int8w plan with
    int8 staging (``repro/kernels/megakernel.py::_plan_cached`` at widths
    (2, 1, 1, 1), batch 1 and ``REFERENCE_VMEM_BUDGET``, as its forward
    plans): the DP over modeled HBM bytes subject to each segment's VMEM
    working set, copied term for term, so that ties break as there. Its
    boundaries are where the reference stages int8."""
    n = len(dils)
    act, wt, inp, stg = 2, 1, 1, 1
    cands = [np.array([t for t in REFERENCE_TILE_CANDIDATES if t <= _ceil_to(v, 8)] or [8], dtype=np.float64)
             for v in vol]
    grids = np.meshgrid(*cands, indexing="ij")
    inf = float("inf")
    best = [inf] * n + [0.0]
    nxt = [n] * n
    for i in range(n - 1, -1, -1):
        cin = in_channels if i == 0 else channels
        ib = inp if i == 0 else stg
        for j in range(i + 1, n + 1):
            d_ij, k, fuse_head = dils[i:j], j - i, j == n
            h = sum(d_ij)
            cout = num_classes if fuse_head else channels
            ob = act if fuse_head else stg
            cum, prods = 0, []
            for layer in range(k + 1):
                s = 2 * (h - cum)
                prods.append((grids[0] + s) * (grids[1] + s) * (grids[2] + s))
                if layer < k:
                    cum += d_ij[layer]
            wgt = 27 * cin * channels * wt + 27 * channels**2 * wt * (k - 1)
            wgt_h = wgt + (channels * num_classes * wt if fuse_head else 0)
            ping = np.maximum.reduce(prods[1::2]) * (channels * act)
            pong = np.maximum.reduce(prods[2::2]) * (channels * act) if k >= 2 else 0.0
            acc = np.maximum.reduce(prods[1:]) * (channels * 4)
            logits = prods[k] * (num_classes * act) if fuse_head else 0.0
            if fuse_head:
                acc = np.maximum(acc, prods[k] * (num_classes * 4))
            qout = prods[k] * (channels * stg) if (not fuse_head and stg < act) else 0.0
            vmem = prods[0] * (cin * ib) + ping + pong + wgt + logits + qout + acc
            padded = [np.ceil(v / g) * g for v, g in zip(vol, grids)]
            ntiles = (padded[0] / grids[0]) * (padded[1] / grids[1]) * (padded[2] / grids[2])
            cost = ntiles * (prods[0] * (cin * ib)) + ntiles * wgt_h
            cost += padded[0] * padded[1] * padded[2] * (cout * ob)
            if i == 0:
                cost += math.prod(vol) * (cin * inp)
                cost += ((padded[0] + 2 * h) * (padded[1] + 2 * h) * (padded[2] + 2 * h)) * (cin * inp)
            cost = np.where(vmem <= REFERENCE_VMEM_BUDGET, cost, inf)
            c = float(cost.reshape(-1)[int(np.argmin(cost))]) + best[j]
            if c < best[i]:
                best[i], nxt[i] = c, j
    if best[0] == inf:
        raise ValueError(f"the reference plans no segment of layer 0 within {REFERENCE_VMEM_BUDGET} bytes of VMEM")
    starts, i = [], 0
    while i < n:
        starts.append(i)
        i = nxt[i]
    return tuple(starts)


# ------------------------------------------------------------- K2, K2r ---


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


def _kernel_lp():
    global _LIB_LP
    if _LIB_LP is None:
        lib = _build.load("megakernel_lp")
        # (x, x_int8, w, hw, vec, out, out_int8, has_deq, geom, n, stream)
        for fn in (lib.repro_megakernel_segment_bf16, lib.repro_megakernel_segment_int8w):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.repro_megakernel_lp_supports.argtypes = [ctypes.c_int]
        lib.repro_megakernel_lp_supports.restype = ctypes.c_int
        lib.repro_megakernel_lp_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.repro_megakernel_lp_blocks_per_sm.restype = ctypes.c_int
        lib.repro_megakernel_lp_error_string.argtypes = [ctypes.c_int]
        lib.repro_megakernel_lp_error_string.restype = ctypes.c_char_p
        _LIB_LP = lib
    return _LIB_LP


def deq_weight_split(w: torch.Tensor, deq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2r's first-layer weights where it dequantises int8 staging, as
    csrc/megakernel_lp.cu stages them: w (3, 3, 3, cin, C), bf16 or int8
    codes, times ``deq`` (cin,) in fp32, split into bf16 hi = rn(w deq) and
    lo = rn(w deq - hi). hi + lo is w deq within 2^-16 relative, and an
    int8 code times each is exact in the bf16 tensor cores: two mmas."""
    wd = w.float() * deq.float()[:, None]
    hi = wd.to(torch.bfloat16)
    return hi, (wd - hi.float()).to(torch.bfloat16)


def scale_operands(pln: MegakernelPlan, i: int) -> tuple[bool, bool]:
    """(deq, qscale): whether segment i of a reduced plan takes per-channel
    dequant scales for its int8 input staging (the previous segment's last
    quantisation scales; the first segment's int8 input carries its scale
    in the first layer's epilogue instead) and quantisation scales for its
    int8 output."""
    x_dtype, out_dtype = pln.dtypes(i)
    return pln.segments[i].start > 0 and x_dtype == torch.int8, out_dtype == torch.int8


def _check_operands(x, pln: MegakernelPlan, i: int, layers, head, deq=None, qscale=None):
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
    if pln.widths == FP32_WIDTHS:
        if deq is not None or qscale is not None:
            raise ValueError("an fp32 plan takes no staging scales")
        return
    # a reduced plan: the staging arrays, weights and scales at its widths
    want_deq, want_q = scale_operands(pln, i)
    if (deq is not None) != want_deq or (qscale is not None) != want_q:
        raise ValueError(f"segment {i} takes deq {'(cin,)' if want_deq else 'None'} and qscale "
                         f"{'(C,)' if want_q else 'None'}")
    if deq is not None and (tuple(deq.shape) != (seg.cin,) or deq.dtype != torch.float32):
        raise ValueError(f"deq must be ({seg.cin},) float32")
    if qscale is not None and (tuple(qscale.shape) != (c,) or qscale.dtype != torch.float32):
        raise ValueError(f"qscale must be ({c},) float32")
    x_dtype, _ = pln.dtypes(i)
    w_dtype = _DTYPE_OF_WIDTH[pln.widths[1]]
    if x.dtype != x_dtype:
        raise TypeError(f"segment {i} of this plan reads a {x_dtype} staging array, got {x.dtype}")
    for li, (w, *vecs) in enumerate(layers):
        if w.dtype != w_dtype or any(t.dtype != torch.float32 for t in vecs):
            raise TypeError(f"layer {li}: w must be {w_dtype} and b, scale, offset float32")
    if head is not None and (head[0].dtype != torch.bfloat16 or head[1].dtype != torch.float32):
        raise TypeError("the head's w must be bfloat16 and its b float32 at a reduced policy")


def blocks_per_sm(seg: Segment, widths: Widths = FP32_WIDTHS, stage: Stage = STAGED) -> int:
    """Blocks of ``seg`` one SM holds, from the built K2 (K2r at reduced
    ``widths``, its input staging array as ``stage`` says; the runtime's
    occupancy calculator), against which ``_blocks_per_sm`` models it. On
    the card only."""
    smem = int(_segment_smem_bytes(seg, widths, stage))
    if widths == FP32_WIDTHS:
        return int(_kernel().repro_megakernel_blocks_per_sm(seg.channels, seg.cin, smem))
    x_int8 = _in_out_widths(seg, widths, stage)[0] == 1
    return int(_kernel_lp().repro_megakernel_lp_blocks_per_sm(seg.channels, int(x_int8), smem))


def band_rows(pln: MegakernelPlan, i: int, band=None) -> tuple[int, int]:
    """The output rows ``[lo, hi)`` segment ``i`` of ``pln`` writes: all
    of its tile-padded region, or ``band`` (host ints) clipped to it."""
    return ref.clip_band(pln.padded(pln.segments[i])[0], band)


def segment_bands(pln: MegakernelPlan, rows, z_bounds=None) -> list[tuple[int, int]]:
    """The output rows each segment of ``pln`` must write so that the last
    one's rows ``[lo, hi)`` are right: segment j's band is ``[lo - R_j, hi
    + R_j)``, R_j the dilations of the segments after it, intersected with
    the valid Z interval (``ref.z_interval``). Segment j + 1 reads exactly
    segment j's band, so no row outside it is ever read."""
    if len(rows) != 2:
        raise ValueError(f"rows must be (lo, hi), got {rows!r}")
    z_lo, z_hi = ref.z_interval(pln.vol[0], z_bounds)
    after = sum(seg.halo for seg in pln.segments)
    bands = []
    for seg in pln.segments:
        after -= seg.halo
        lo, hi = max(int(rows[0]) - after, z_lo), min(int(rows[1]) + after, z_hi)
        bands.append((lo, max(hi, lo)))
    return bands


def band_rows_layers(pln: MegakernelPlan, bands=None) -> int:
    """Rows times layers a forward of ``pln`` computes: each segment's band
    (``segment_bands``; its whole tile-padded region without one) times its
    layers."""
    return sum((hi - lo) * len(seg.dilations) for seg, (lo, hi) in zip(
        pln.segments, bands or [band_rows(pln, i) for i in range(len(pln.segments))]))


def geometry(x_shape: tuple, pln: MegakernelPlan, i: int, z_bounds=None, band=None) -> list[int]:
    """The geometry array K2's (K2r's) entry point takes for segment ``i``
    of ``pln`` on an input staging array of shape ``x_shape``: B, cin, C,
    k, classes (0 without the head), vol, tile, the input's dims and halo,
    the output's dims and halo, the shared-memory layout (params, ping,
    pong, ring floats; the kernel checks it against its own), the valid Z
    interval [z_lo, z_hi) (``ref.z_interval``: the volume's, or its
    intersection with ``z_bounds``; K2z), the output rows written
    [band_lo, band_hi) (``band_rows``), then the dilations."""
    seg = pln.segments[i]
    return [
        x_shape[0], seg.cin, seg.channels, len(seg.dilations), seg.num_classes if seg.fuse_head else 0,
        *pln.vol, *seg.tile, *x_shape[1:4], seg.halo, *pln.out_dims(i), pln.out_halo(i),
        *(int(v) for v in _smem_layout(seg, pln.widths, pln.stage(i))), *ref.z_interval(pln.vol[0], z_bounds),
        *band_rows(pln, i, band), *seg.dilations,
    ]


def staging_strides(shape: tuple, dtype: torch.dtype) -> tuple:
    """Element strides of a K2r staging array of ``shape`` (B, Z, Y, X, C),
    channels-last (csrc/megakernel_lp.cu). A bf16 array of several
    channels holds each position at a multiple of 8 channels (16 bytes a
    group; C = 5: 16 bytes a position), so that K2r copies a position's
    channels straight into its A operands' layout, the pad zero-filled on
    the way and never read; any other (int8, or one channel) is packed
    with each x row's pitch padded to a multiple of 16 bytes, so that
    every row starts 16-byte aligned and K2r copies it in 16-byte
    granules. The pads are never written as data or read."""
    es = torch.tensor([], dtype=dtype).element_size()
    if dtype == torch.bfloat16 and shape[4] > 1:
        pos = -(-shape[4] // 8) * 8
        pitch = shape[3] * pos
    else:
        pos = shape[4]
        pitch = -(-shape[3] * shape[4] * es // 16) * 16 // es
    return (shape[1] * shape[2] * pitch, shape[2] * pitch, pitch, pos, 1)


def staging_empty(shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised K2r staging array of logical ``shape`` with the
    layout of ``staging_strides`` (a view of a flat buffer)."""
    strides = staging_strides(shape, dtype)
    flat = torch.empty(shape[0] * strides[0], dtype=dtype, device=device)
    return flat.as_strided(tuple(shape), strides)


def is_staging(t: torch.Tensor) -> bool:
    """Whether ``t`` has ``staging_strides``' layout and a 16-byte aligned
    start, as K2r reads and writes staging arrays."""
    return t.ndim == 5 and t.stride() == staging_strides(tuple(t.shape), t.dtype) and t.data_ptr() % 16 == 0


def run_segment(
    x: torch.Tensor,
    pln: MegakernelPlan,
    i: int,
    layers: Sequence[tuple],
    head: Optional[tuple] = None,
    deq: Optional[torch.Tensor] = None,
    qscale: Optional[torch.Tensor] = None,
    z_bounds: Optional[tuple[int, int]] = None,
    band: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Segment ``i`` of ``pln`` on the staging array ``x``: (B, Z, Y, X,
    cin) holding the volume at offset ``segments[i].halo`` (its border is
    never read). ``layers`` gives each layer's (w, b, scale, offset), the
    folded BatchNorm (and an int8 dequant scale) in scale and offset;
    ``head`` the fused head's (w (C, classes), b) when the segment fuses
    it. Returns the output staging array (B, *pln.out_dims(i), cout) whose
    region [out_halo(i), out_halo(i) + padded) is written and whose border
    is not.

    An fp32 plan runs K2: every tensor fp32. A reduced plan runs K2r at
    its widths (``pln.dtypes``): a bf16 or int8 staging array in and out
    (bf16 logits), bf16 or int8 weights, fp32 bias, scale and offset, a
    bf16 head weight; ``deq`` (cin,) fp32 scales its int8 input staging
    and ``qscale`` (C,) fp32 quantises its int8 output, exactly when
    ``scale_operands`` says. On the card a reduced plan's output staging
    array (not the head's logits) has ``staging_strides``' layout; the CPU
    path returns plain contiguous arrays.

    ``z_bounds`` (host ints ``(z_lo, z_hi)``; K2z, and K2r-z on a reduced
    plan) narrows the valid Z interval to its intersection with
    ``[0, vol[0])``: input rows outside it are read as zeros and every
    layer's output rows but the last's are zeroed, as outside the volume.
    The same kernels, the bounds a runtime value: no rebuild per window.

    ``band`` (host ints ``(lo, hi)``, ``band_rows``) writes only the
    output rows in ``[lo, hi)``, computed from the input rows within the
    segment's halo of them; the other output rows are left unwritten and
    the other input rows are never read.

    On CUDA every tensor must be contiguous on x's device (a reduced
    plan's staging array with ``staging_strides``' layout, 16-byte
    aligned), the width one the kernel is instantiated for (5, 10, 18,
    21), and the segment's shared memory within one block."""
    global launches, reduced_launches, z_launches
    _check_operands(x, pln, i, layers, head, deq, qscale)
    if z_bounds is not None and len(z_bounds) != 2:
        raise ValueError(f"z_bounds must be (z_lo, z_hi), got {z_bounds!r}")
    if band is not None and len(band) != 2:
        raise ValueError(f"band must be (lo, hi), got {band!r}")
    if x.device.type == "cpu":
        return ref.megakernel_segment(x, pln, i, layers, head, deq, qscale, z_bounds, band)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    reduced = pln.widths != FP32_WIDTHS
    tensors = [x] + [t for layer in layers for t in layer] + list(head or ()) + [t for t in (deq, qscale) if t is not None]
    for t in tensors:
        if not reduced and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    for t in tensors[1:] if reduced else tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    seg = pln.segments[i]
    lib = _kernel_lp() if reduced else _kernel()
    supports = lib.repro_megakernel_lp_supports if reduced else lib.repro_megakernel_supports
    if not supports(seg.channels):
        raise ValueError(f"the CUDA kernel is not instantiated for Cout={seg.channels}")
    if reduced and not is_staging(x):
        raise ValueError("K2r takes its staging array contiguous but for its x-row pitch, padded to 16 bytes, and "
                         "16-byte aligned (megakernel.staging_empty)")
    if len(seg.dilations) > MAX_LAYERS:
        raise ValueError(f"a segment holds at most {MAX_LAYERS} layers, got {len(seg.dilations)}")
    smem = _segment_smem_bytes(seg, pln.widths, pln.stage(i))
    if smem > SMEM_BUDGET:
        raise ValueError(f"segment {i} needs {smem} bytes of shared memory, over the {SMEM_BUDGET} one block can use")
    _, out_dtype = pln.dtypes(i)
    shape = (x.shape[0],) + pln.out_dims(i) + (seg.cout,)
    if reduced and not seg.fuse_head:
        out = staging_empty(shape, out_dtype, x.device)
    else:
        out = torch.empty(shape, dtype=out_dtype, device=x.device)
    geom = geometry(tuple(x.shape), pln, i, z_bounds, band)
    geom_c = (ctypes.c_int * len(geom))(*geom)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if not reduced:
        params = torch.cat([t.reshape(-1) for t in tensors[1:]])
        err = lib.repro_megakernel_segment_f32(x.data_ptr(), params.data_ptr(), out.data_ptr(), geom_c, len(geom), stream)
        if err != 0:
            raise RuntimeError(f"megakernel launch failed: {lib.repro_megakernel_error_string(err).decode()}")
        if z_bounds is None:
            launches += 1
        else:
            z_launches += 1
        return out
    # K2r: the conv weights at their width, the head's bf16 weights, then
    # one fp32 vector: each layer's bias, scale, offset, the head's bias,
    # the dequant scales (ones: the first layer's taps taken as they are)
    # and the quantisation scales (ones when the output is bf16)
    w = torch.cat([layer[0].reshape(-1) for layer in layers])
    vec = [t for layer in layers for t in layer[1:]]
    if head is not None:
        vec.append(head[1])
    vec.append(deq if deq is not None else torch.ones(seg.cin, device=x.device))
    vec.append(qscale if qscale is not None else torch.ones(seg.channels, device=x.device))
    vec = torch.cat(vec)
    hw = head[0] if head is not None else None
    entry = lib.repro_megakernel_segment_int8w if w.dtype == torch.int8 else lib.repro_megakernel_segment_bf16
    err = entry(
        x.data_ptr(), int(x.dtype == torch.int8), w.data_ptr(), None if hw is None else hw.data_ptr(),
        vec.data_ptr(), out.data_ptr(), int(out.dtype == torch.int8), int(deq is not None), geom_c, len(geom), stream,
    )
    if err != 0:
        raise RuntimeError(f"reduced megakernel launch failed: {lib.repro_megakernel_lp_error_string(err).decode()}")
    if z_bounds is None:
        reduced_launches += 1
    else:
        z_launches += 1
    return out
