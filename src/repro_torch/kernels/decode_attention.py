"""Wrapper of K4, single-token GQA decode attention over a KV cache.

Counterpart of ``repro/kernels/decode_attention.py::decode_attention``.
The kernel is CUDA C++ for sm_90a (``csrc/decode_attention.cu``, whose
header says how it walks the cache and what bounds it), loaded through
``_build``. ``models/layers.py::attention_decode`` calls it once per
attention layer of every decode step.

``pos`` is a host int or, like the reference's operand, a ``(1,)`` int32
tensor on q's device that the kernel reads there. A call is one launch of
a fixed grid, ``(nsplit(S, B * KV), KV, B)``, whatever ``pos`` is; its
fp32 workspace and arrival counters are allocated once per (device, B, KV,
nsplit, G, hd) and kept, so a call allocates nothing besides its output
and never synchronises, and a CUDA graph can hold it and be replayed at
any position written into the same ``pos`` tensor. Calls of one shape on
two streams at once would share that workspace: keep them on one stream.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``kernels/ref.py::decode_attention``). ``launches`` counts calls
that launched the kernel and nothing else, so a run can show that its
path went through it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Union

import torch

from repro_torch.kernels import _build, ref

#: blocks the grid takes at most (one per SM of an H100, so all are
#: resident at once and the chunks to merge are few), and the fewest slots
#: a block takes at a full cache.
TARGET_BLOCKS = 132
MIN_SLOTS = 32
#: warps of a block; each takes a share of the block's chunk.
WARPS = 4

#: calls that launched the kernel since the counter was last reset (CPU
#: calls don't count).
launches = 0

_LIB = None
_WORKSPACES: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

Pos = Union[int, torch.Tensor]


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        fn = lib.repro_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.repro_decode_attention_smem_bytes.restype = ctypes.c_longlong
        for fn in (lib.repro_decode_attention_max_group, lib.repro_decode_attention_max_head_dim):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.repro_decode_attention_partial_floats.argtypes = [ctypes.c_int] * 2
        lib.repro_decode_attention_partial_floats.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def nsplit(S: int, rows: int) -> int:
    """Chunks the kernel cuts each (batch row, KV head) into, from the cache
    length ``S`` and ``rows`` = batch x KV heads alone: at most
    ``TARGET_BLOCKS`` blocks in all (one a row at least), none over fewer
    than ``MIN_SLOTS`` slots of a full cache."""
    return max(1, min(TARGET_BLOCKS // max(rows, 1), math.ceil(S / MIN_SLOTS)))


def chunk(i: int, n: int, length: int) -> tuple[int, int]:
    """The i-th of n near-equal pieces of [0, length): the kernel's rule,
    for a block's chunk of the valid slots and a warp's share of it."""
    return i * length // n, (i + 1) * length // n


def chunks(n_valid: int, splits: int) -> list[tuple[int, int]]:
    """[begin, end) of the slots every (block, warp) of one (batch row, KV
    head) reads, in the kernel's order, at ``n_valid`` valid slots."""
    out = []
    for s in range(splits):
        c0, c1 = chunk(s, splits, n_valid)
        for w in range(WARPS):
            b, e = chunk(w, WARPS, c1 - c0)
            out.append((c0 + b, c0 + e))
    return out


def _check(q, k, v, pos):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got shape {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != hd or k.shape != v.shape:
        raise ValueError(
            f"k and v must be (B={B}, S, KV, hd={hd}) of one shape, got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[2]} KV heads")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or tuple(pos.shape) != (1,) or pos.device != q.device:
            raise ValueError(f"a tensor pos must be (1,) int32 on {q.device}, got {tuple(pos.shape)} "
                             f"{pos.dtype} on {pos.device}")
    elif int(pos) != pos or pos < 0:
        raise ValueError(f"pos must be an integer >= 0, got {pos!r}")


@functools.lru_cache(maxsize=None)
def _shape_fits(G: int, hd: int, elem: int) -> None:
    """Raise ValueError unless the kernel takes G heads a group of dimension
    hd at ``elem``-byte elements (asked once a shape: a decode step makes
    one call a layer)."""
    lib = _kernel()
    if G > lib.repro_decode_attention_max_group() or hd > lib.repro_decode_attention_max_head_dim():
        raise ValueError(f"G={G} query heads a KV head and hd={hd}: the kernel takes at most "
                         f"{lib.repro_decode_attention_max_group()} and {lib.repro_decode_attention_max_head_dim()}")
    smem = lib.repro_decode_attention_smem_bytes(G, hd, elem)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"G={G}, hd={hd} needs {smem} bytes of shared memory, over the {_build.SMEM_LIMIT} one block can use"
        )


def _workspace(device, B: int, KV: int, splits: int, G: int, hd: int):
    """(partials, counters) of the shape, made on its first call and kept:
    fp32 (acc, m, l) of every chunk, and one arrival count a (batch row, KV
    head), which every launch leaves at 0."""
    key = (device, B, KV, splits, G, hd)
    if key not in _WORKSPACES:
        row = _kernel().repro_decode_attention_partial_floats(G, hd)
        _WORKSPACES[key] = (torch.empty((B * KV * splits * row,), dtype=torch.float32, device=device),
                            torch.zeros((B * KV,), dtype=torch.int32, device=device))
    return _WORKSPACES[key]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: Pos) -> torch.Tensor:
    """q (B, 1, H, hd) against k/v (B, S, KV, hd), attending to slots
    [0, pos] (all S when pos >= S) -> (B, 1, H, hd) in q's dtype. ``pos``
    is a host integer >= 0 or a (1,) int32 tensor on q's device (read on
    the device, never on the host: a negative value there attends to no
    slot and gives zeros on the card).

    On CUDA q, k, v must be contiguous, of one dtype (float32 or bfloat16)
    and on one device, k and v 16-byte aligned with hd values a multiple of
    16 bytes, at most 16 query heads a KV head and hd at most 256."""
    global launches
    _check(q, k, v, pos)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return ref.decode_attention(q, k, v, pos)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"no kernel for q on {q.device}, k on {k.device}, v on {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"the CUDA kernel takes float32 or bfloat16, all one type; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors only ({name} is not)")
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    elem = q.element_size()
    if (hd * elem) % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel copies 16 bytes at a time: hd={hd} of {q.dtype} must be a multiple of "
                         f"16 bytes and k, v 16-byte aligned")
    _shape_fits(G, hd, elem)
    out = torch.empty_like(q)
    if B * S == 0:
        return out.zero_()
    splits = nsplit(S, B * KV)
    part, count = _workspace(q.device, B, KV, splits, G, hd)
    lib = _kernel()
    on_card = isinstance(pos, torch.Tensor)
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(), count.data_ptr(),
        pos.data_ptr() if on_card else None, 0 if on_card else min(int(pos), S - 1),
        int(q.dtype == torch.bfloat16), B, S, KV, G, hd, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: {lib.repro_cuda_error_string(err).decode()}")
    launches += 1
    return out
