"""Wrappers of K1, K1r and K5, the fused 3x3x3 dilated conv (+ folded BN + ReLU).

Counterpart of ``repro/kernels/dilated_conv3d.py::dilated_conv3d``, whose
``variant`` picks the schedule: ``"halo"`` (K1, ``csrc/dilated_conv3d.cu``
on the conv tile core ``csrc/conv_tile.cuh``: a warp a chunk of up to
32 R voxels of M output rows d apart, R voxels x Cout channels a row in
registers per lane, one input box per (tz, input row) staged by cp.async
into a double-buffered ring) or
``"views"`` (K5, ``csrc/dilated_conv3d_views.cu``, the 27-shifted-tile
schedule, bit-equal to K1 and its oracle on the card). Both are CUDA C++
for sm_90a (each source's header says what bounds it), loaded through
``_build``. A bf16 ``x`` takes K1r (``csrc/dilated_conv3d_lp.cu``), the
halo kernel's function at the reduced policies: bf16 or int8 weights,
fp32 accumulation and epilogue, a bf16 output rounded once; on the bf16
tensor cores, each input row a tile reads staged once in shared memory
(its tile and shared memory mirrored here: ``lp_tile``, ``lp_layout``).
Its inputs and outputs stay contiguous ``(B, D, H, W, C)``: the channel
padding lives in its shared memory only.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``kernels/ref.py``), which computes the same function for both.
``launches`` (K1), ``reduced_launches`` (K1r) and ``views_launches`` (K5)
count kernel launches and nothing else, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

SMEM_LIMIT = _build.SMEM_LIMIT

#: kernel launches since the counter was last reset (CPU calls don't count):
#: K1's, K1r's and K5's.
launches = 0
reduced_launches = 0
views_launches = 0

#: side of K5's cubic output tile (one thread per voxel).
VIEWS_TILE = 8

#: variant -> (source name, C entry point prefix)
_SOURCES = {"halo": ("dilated_conv3d", "repro_dilated_conv3d"),
            "views": ("dilated_conv3d_views", "repro_dilated_conv3d_views")}
_LIBS: dict = {}


#: the conv tile core's block (csrc/conv_tile.cuh kWarps): 4 warps, K1's
#: at most, K2's always; and the boxes each warp keeps in its ring
#: (kStages).
WARPS = 4
STAGES = 2


def voxels_per_lane(cout: int) -> int:
    """R, the output voxels along x one lane of K1 or K2 computes in each
    of its rows for ``cout`` channels (csrc/conv_tile.cuh ``Blocking``)."""
    return 8 if cout <= 5 else 4


def rows_per_warp(cout: int) -> int:
    """M, the output rows (d apart in y) one warp of K1 or K2 computes
    for ``cout`` channels (csrc/conv_tile.cuh ``Blocking``)."""
    return 2 if cout <= 10 else 1


def _ceil4(v: int) -> int:
    return -(-v // 4) * 4


def k1_layout(cin: int, cout: int) -> tuple[int, int, int]:
    """(warps a block, ring positions a box, shared-memory floats) of K1
    for cin -> cout, the rule of ``csrc/dilated_conv3d.cu::layout``: the
    weights at row stride Cout rounded up to 4, bias, scale and offset
    (3 Cout rounded up to 4), then every warp's ring of 2 slots of
    ceil4(WB (Cin | 1)) + 4 floats, WB = 32 R + 32; 4 warps where that
    fits, else 2 or 1, then a narrower box (never below 3 positions; over
    the limit it cannot launch)."""
    cs = cin | 1
    fixed = 27 * cin * _ceil4(cout) + _ceil4(3 * cout)
    limit = SMEM_LIMIT // 4
    wb = 32 * voxels_per_lane(cout) + 32
    warps = WARPS
    def slot(wb):
        return _ceil4(wb * cs) + 4

    while warps >= 1:
        floats = fixed + warps * STAGES * slot(wb)
        if floats <= limit:
            return warps, wb, floats
        warps //= 2
    avail = (limit - fixed) // STAGES - 4
    wb = max(int(avail / 4) * 4 // cs if avail >= 0 else -1, 3)  # C's truncating division
    return 1, wb, fixed + STAGES * slot(wb)


def smem_bytes(cin: int, cout: int, variant: str = "halo") -> int:
    """Shared memory one block allocates. K1: its weights, bias, scale and
    offset, then its warps' staging ring (``k1_layout``). K5: weights,
    bias, scale and offset, then one (8, 8, 8, Cin) input tile."""
    if variant == "views":
        return (27 * cin * cout + 3 * cout + VIEWS_TILE**3 * cin) * 4
    return 4 * k1_layout(cin, cout)[2]


def _kernel(variant: str):
    """(library, launch function, supports function) of a variant's kernel."""
    if variant not in _LIBS:
        name, prefix = _SOURCES[variant]
        lib = _build.load(name)
        fn = getattr(lib, f"{prefix}_f32")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if variant == "halo":
            lib.repro_dilated_conv3d_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.repro_dilated_conv3d_smem_bytes.restype = ctypes.c_longlong
            lib.repro_dilated_conv3d_blocks.argtypes = [ctypes.c_int] * 7
            lib.repro_dilated_conv3d_blocks.restype = ctypes.c_longlong
            lib.repro_dilated_conv3d_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.repro_dilated_conv3d_blocks_per_sm.restype = ctypes.c_int
        supports = getattr(lib, f"{prefix}_supports")
        supports.argtypes = [ctypes.c_int]
        supports.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[variant] = (lib, fn, supports)
    return _LIBS[variant]


#: output widths K1r is instantiated for, and the warps of its widest
#: block (csrc/dilated_conv3d_lp.cu)
LP_WIDTHS = (5, 10, 18, 21)
LP_WARPS = 4


def lp_blocking(cout: int) -> tuple[int, int]:
    """(output rows a warp of K1r computes, d apart in y; m16 tiles along x
    of its widest tile) for ``cout`` channels (csrc/dilated_conv3d_lp.cu
    ``Tc``): (2, 4) at C <= 8, (3, 2) at C <= 16, else (4, 1)."""
    return (2, 4) if cout <= 8 else (3, 2) if cout <= 16 else (4, 1)


def _ceil16(v: int) -> int:
    return -(-v // 16) * 16


@dataclasses.dataclass(frozen=True)
class LpLayout:
    """One K1r block's shared memory in bytes (csrc/dilated_conv3d_lp.cu
    ``layout_of``): the zero group (16 bytes), B fragments at ``frag``, the
    A-offset table, bias/scale/offset at ``vec`` and after them 4 warps'
    mbarriers (8 bytes each), the staged rows at ``rows``, the raw buffer at
    ``raw`` (a tile's rows as copied; none when Cin is a multiple of 8), the
    output rows at ``obuf``; ``sx`` positions between an x tap's windows,
    ``nsl`` positions of ``pb`` bytes a staged row, ``raw_slot`` raw bytes
    a staged row, ``obuf_row`` bytes an output row."""

    frag: int
    table: int
    vec: int
    rows: int
    raw: int
    obuf: int
    total: int
    sx: int
    nsl: int
    pb: int
    raw_slot: int
    obuf_row: int


def lp_layout(cin: int, cout: int, dilation: int, tile: tuple[int, int, int]) -> LpLayout:
    """K1r's shared memory for cin -> cout at ``dilation`` on ``tile`` =
    (warps, i.e. z rows; y rows a warp; m16 tiles along x)."""
    mz, my, mt = tile
    cg = -(-cin // 8)
    ks, nt, nx = (3 * cg + 1) // 2, -(-cout // 8), 16 * mt
    frag = 16
    table = frag + 9 * ks * nt * 256
    vec = table + _ceil16(8 * ks)
    rows = vec + _ceil16(12 * cout) + 8 * LP_WARPS  # then one mbarrier a warp
    sx = min(dilation, nx)
    nsl, pb = nx + 2 * sx, (cg | 1) * 16
    slots = (mz + 2) * (my + 2)
    raw = rows + slots * nsl * pb
    raw_slot = 0
    if cin % 8:
        # whole groups of 8 positions (16 Cin bytes) that cover a span
        raw_slot = (16 * cin * (-(-(nx + 2 * dilation) // 8) + 1) if sx == dilation
                    else 3 * 16 * cin * (nx // 8 + 1))
    obuf = raw + slots * raw_slot
    obuf_row = _ceil16(2 * nx * cout) + 32  # a row, or two halves of ceil16(nx Cout) + 16
    total = obuf + mz * my * obuf_row
    return LpLayout(frag, table, vec, rows, raw, obuf, total, sx, nsl, pb, raw_slot, obuf_row)


def _lp_tiles(cin: int, cout: int, dilation: int):
    """K1r's candidate tiles, widest first: 4, 2, then 1 warp, each at the
    width's m16 tiles and then at one; last one row of 16 voxels a block."""
    my, mt0 = lp_blocking(cout)
    for mz in (4, 2, 1):
        for mt in dict.fromkeys((mt0, 1)):
            yield mz, my, mt
    yield 1, 1, 1


def lp_tile(cin: int, cout: int, dilation: int) -> Optional[tuple[int, int, int]]:
    """The tile K1r launches for cin -> cout at ``dilation``, (warps, y rows
    a warp, m16 tiles along x): the first of ``_lp_tiles`` whose shared
    memory fits one block; None if none does (the wrapper refuses)."""
    for tile in _lp_tiles(cin, cout, dilation):
        if lp_layout(cin, cout, dilation, tile).total <= SMEM_LIMIT:
            return tile
    return None


def lp_smem_bytes(cin: int, cout: int, dilation: int) -> int:
    """Shared memory one block of K1r allocates for cin -> cout at
    ``dilation`` (the narrowest tile's when none fits)."""
    tile = lp_tile(cin, cout, dilation) or (1, 1, 1)
    return lp_layout(cin, cout, dilation, tile).total


def _row_groups(n: int, d: int, m: int) -> list[int]:
    """The first rows of the groups of up to m rows d apart that cover n
    rows (conv_tile.cuh ``row_groups``, ``group_row``)."""
    return sorted(r0 + k * m * d for r0 in range(min(d, n)) for k in range(-(-(n - r0) // (m * d))))


def _staged(n: int, d: int, m: int) -> int:
    """Input rows along one axis the groups of m rows over n rows stage:
    for a group of e rows, those of its e + 2 rows at (j - 1) d from its
    first that lie in [0, n)."""
    total = 0
    for r0 in _row_groups(n, d, m):
        e = min(m, (n - 1 - r0) // d + 1)
        total += sum(0 <= r0 + (j - 1) * d < n for j in range(e + 2))
    return total


def lp_staged_rows(shape: tuple, cin: int, cout: int, dilation: int) -> int:
    """Input row spans K1r copies into shared memory over one launch on
    ``shape`` (B, D, H, W): per tile, each of its (mz + 2)(my + 2) rows
    that an output row reads and that lies in the volume, once; a span is
    the tile's NX voxels and the 2 d positions its x taps reach."""
    B, D, H, W = shape
    mz, my, mt = lp_tile(cin, cout, dilation)
    return B * _staged(D, dilation, mz) * _staged(H, dilation, my) * -(-W // (16 * mt))


def lp_tile_count(shape: tuple, cin: int, cout: int, dilation: int) -> int:
    """Tiles one K1r launch on ``shape`` (B, D, H, W) walks."""
    B, D, H, W = shape
    mz, my, mt = lp_tile(cin, cout, dilation)
    return B * len(_row_groups(D, dilation, mz)) * len(_row_groups(H, dilation, my)) * -(-W // (16 * mt))


def lp_blocks_per_sm_model(cin: int, cout: int, dilation: int, registers: int) -> int:
    """Blocks of K1r one SM holds, by shared memory (228 KB an SM, 1 KB of
    it reserved a block), registers (65,536 an SM, ``registers`` a thread
    rounded up to 8), threads (2,048) and blocks (32): the runtime's rule,
    as ``megakernel._blocks_per_sm`` has it for K2."""
    threads = 32 * lp_tile(cin, cout, dilation)[0]
    by_smem = 233_472 // (lp_smem_bytes(cin, cout, dilation) + 1024)
    by_regs = 65_536 // (-(-registers // 8) * 8 * threads)
    return min(by_smem, by_regs, 2048 // threads, 32)


@functools.cache
def _lp_kernel():
    """(library, launch function, supports function) of K1r."""
    lib = _build.load("dilated_conv3d_lp")
    fn = lib.repro_dilated_conv3d_lp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_dilated_conv3d_lp_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.repro_dilated_conv3d_lp_blocks_per_sm.restype = ctypes.c_int
    lib.repro_dilated_conv3d_lp_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_dilated_conv3d_lp_smem_bytes.restype = ctypes.c_longlong
    lib.repro_dilated_conv3d_lp_tile.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.repro_dilated_conv3d_lp_tile.restype = ctypes.c_int
    lib.repro_dilated_conv3d_lp_registers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.repro_dilated_conv3d_lp_registers.restype = ctypes.c_int
    lib.repro_dilated_conv3d_lp_supports.argtypes = [ctypes.c_int]
    lib.repro_dilated_conv3d_lp_supports.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn, lib.repro_dilated_conv3d_lp_supports


def lp_library_tile(cin: int, cout: int, dilation: int) -> Optional[tuple[int, int, int]]:
    """The tile the built K1r chooses (None where it refuses). On the card
    only."""
    out = (ctypes.c_int * 3)()
    ok = _lp_kernel()[0].repro_dilated_conv3d_lp_tile(cin, cout, dilation, out) == 0
    return tuple(out) if ok else None


def lp_blocks_per_sm(cin: int, cout: int, dilation: int, w_int8: bool) -> int:
    """Blocks of K1r an SM holds (the runtime's occupancy calculator). On
    the card only."""
    return int(_lp_kernel()[0].repro_dilated_conv3d_lp_blocks_per_sm(cin, cout, dilation, int(w_int8)))


def lp_registers(cin: int, cout: int, dilation: int, w_int8: bool) -> tuple[int, int]:
    """(registers a thread, local bytes a thread, i.e. spills) of the K1r
    kernel that cin -> cout at ``dilation`` launches (the runtime's
    function attributes). On the card only."""
    out = (ctypes.c_int * 2)()
    if _lp_kernel()[0].repro_dilated_conv3d_lp_registers(cin, cout, dilation, int(w_int8), out) != 0:
        raise RuntimeError(f"K1r has no kernel for {cin} -> {cout} at d={dilation}")
    return int(out[0]), int(out[1])


def k1_occupancy(shape: tuple, cin: int, cout: int, dilation: int) -> tuple[int, int]:
    """(blocks, blocks an SM holds) of one K1 launch over ``shape`` (B, D,
    H, W), from the built kernel (the runtime's occupancy calculator). On
    the card only."""
    lib = _kernel("halo")[0]
    return (int(lib.repro_dilated_conv3d_blocks(*shape, cin, cout, dilation)),
            int(lib.repro_dilated_conv3d_blocks_per_sm(cin, cout)))


def _check_shapes(x, w, b, scale, offset, dilation):
    if x.ndim != 5:
        raise ValueError(f"x must be (B, D, H, W, Cin), got shape {tuple(x.shape)}")
    if w.ndim != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != x.shape[-1]:
        raise ValueError(
            f"w must be (3, 3, 3, {x.shape[-1]}, Cout), got shape {tuple(w.shape)}"
        )
    cout = w.shape[-1]
    for name, t in (("b", b), ("scale", scale), ("offset", offset)):
        if t is not None and tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got shape {tuple(t.shape)}")
    if int(dilation) != dilation or dilation < 1:
        raise ValueError(f"dilation must be an integer >= 1, got {dilation!r}")


def dilated_conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    dilation: int = 1,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    fuse_affine: bool = False,
    variant: str = "halo",
) -> torch.Tensor:
    """'Same' 3x3x3 dilated conv: x (B, D, H, W, Cin), w (3, 3, 3, Cin,
    Cout), b (Cout,) -> (B, D, H, W, Cout). With ``fuse_affine``:
    ``relu((conv + b) * scale + offset)``, scale 1 and offset 0 when absent.
    ``variant``: "halo" (K1) or "views" (K5), one function. A bfloat16
    ``x`` with variant "halo" is K1r's: bf16 or int8 ``w``, fp32 ``b``,
    ``scale`` and ``offset``, accumulation in fp32 and a bf16 output.

    On CUDA every tensor must be contiguous on x's device, fp32 for K1 and
    K5, Cout one of the kernels' instantiated widths (5, 10, 18, 21), and
    what a block stages within its shared memory."""
    global launches, views_launches
    if variant not in _SOURCES:
        raise ValueError(f"variant must be 'halo' or 'views', got {variant!r}")
    _check_shapes(x, w, b, scale, offset, dilation)
    if x.device.type == "cpu":
        return ref.dilated_conv3d(
            x, w, b, dilation=dilation, scale=scale, offset=offset, fuse_affine=fuse_affine
        )
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype == torch.bfloat16 and variant == "halo":
        return _reduced(x, w, b, dilation, scale, offset, fuse_affine)
    cin, cout = w.shape[3], w.shape[4]
    if fuse_affine:
        scale = torch.ones(cout, device=x.device) if scale is None else scale
        offset = torch.zeros(cout, device=x.device) if offset is None else offset
    operands = [x, w, b] + ([scale, offset] if fuse_affine else [])
    for t in operands:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    lib, launch, supports = _kernel(variant)
    if not supports(cout):
        raise ValueError(f"the CUDA kernel is not instantiated for Cout={cout}")
    if smem_bytes(cin, cout, variant) > SMEM_LIMIT:
        raise ValueError(
            f"Cin={cin} x Cout={cout} needs {smem_bytes(cin, cout, variant)} bytes of "
            f"shared memory, over the {SMEM_LIMIT} one block can use"
        )
    B, D, H, W, _ = x.shape
    out = torch.empty((B, D, H, W, cout), dtype=torch.float32, device=x.device)
    err = launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        scale.data_ptr() if fuse_affine else None,
        offset.data_ptr() if fuse_affine else None,
        out.data_ptr(), B, D, H, W, cin, cout, int(dilation), int(fuse_affine),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"dilated_conv3d ({variant}) kernel launch failed: {lib.repro_cuda_error_string(err).decode()}"
        )
    if variant == "views":
        views_launches += 1
    else:
        launches += 1
    return out


def lp_check(x, w, b, dilation, scale, offset, fuse_affine):
    """What K1r takes, checked before a launch: bf16 or int8 weights, fp32
    bias, scale and offset, every operand contiguous on x's device, an
    instantiated Cout and a tile whose shared memory fits a block. Raises
    TypeError or ValueError; returns (scale, offset), 1 and 0 where absent
    and fused."""
    cin, cout = w.shape[3], w.shape[4]
    if w.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"K1r takes bfloat16 or int8 weights, got {w.dtype}")
    if fuse_affine:
        scale = torch.ones(cout, device=x.device) if scale is None else scale
        offset = torch.zeros(cout, device=x.device) if offset is None else offset
    vectors = [b] + ([scale, offset] if fuse_affine else [])
    for t in vectors:
        if t.dtype != torch.float32:
            raise TypeError(f"K1r takes a float32 bias, scale and offset, got {t.dtype}")
    for t in [x, w] + vectors:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    if cout not in LP_WIDTHS:
        raise ValueError(f"K1r is not instantiated for Cout={cout}")
    if lp_tile(cin, cout, int(dilation)) is None:
        raise ValueError(
            f"Cin={cin} x Cout={cout} at d={dilation} needs {lp_smem_bytes(cin, cout, int(dilation))} bytes "
            f"of shared memory, over the {SMEM_LIMIT} one block can use"
        )
    return scale, offset


def _reduced(x, w, b, dilation, scale, offset, fuse_affine) -> torch.Tensor:
    """One launch of K1r: x bf16, w bf16 or int8, b (and scale, offset)
    fp32; a bf16 output."""
    global reduced_launches
    cin, cout = w.shape[3], w.shape[4]
    scale, offset = lp_check(x, w, b, dilation, scale, offset, fuse_affine)
    lib, launch, _ = _lp_kernel()
    B, D, H, W, _ = x.shape
    out = torch.empty((B, D, H, W, cout), dtype=torch.bfloat16, device=x.device)
    err = launch(
        x.data_ptr(), w.data_ptr(), int(w.dtype == torch.int8), b.data_ptr(),
        scale.data_ptr() if fuse_affine else None,
        offset.data_ptr() if fuse_affine else None,
        out.data_ptr(), B, D, H, W, cin, cout, int(dilation), int(fuse_affine),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dilated_conv3d (K1r) kernel launch failed: {lib.repro_cuda_error_string(err).decode()}")
    reduced_launches += 1
    return out
