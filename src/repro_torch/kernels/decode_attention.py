"""Wrapper of K4, single-token GQA decode attention over a KV cache.

Counterpart of ``repro/kernels/decode_attention.py::decode_attention``.
The kernel is CUDA C++ for sm_90a (``csrc/decode_attention.cu``, whose
header says how it walks the cache and what bounds it), loaded through
``_build``. ``models/layers.py::attention_decode`` calls it once per
attention layer of every decode step.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``kernels/ref.py::decode_attention``). ``launches`` counts calls
that launched the kernel and nothing else, so a run can show that its
path went through it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

#: blocks the wrapper aims for by cutting the valid slots into chunks (two
#: per SM of an H100), and the fewest slots a chunk takes (one tile).
TARGET_BLOCKS = 264
MIN_CHUNK = 64

#: calls that launched the kernel since the counter was last reset (CPU
#: calls don't count).
launches = 0

_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        fn = lib.repro_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_decode_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.repro_decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def split(n_valid: int, rows: int) -> tuple[int, int]:
    """(chunks, slots a chunk) for ``n_valid`` slots and ``rows`` =
    batch x KV heads: about ``TARGET_BLOCKS`` blocks in all, no chunk under
    ``MIN_CHUNK`` slots, none empty."""
    want = max(1, min(math.ceil(n_valid / MIN_CHUNK), math.ceil(TARGET_BLOCKS / rows)))
    chunk = math.ceil(n_valid / want)
    return math.ceil(n_valid / chunk), chunk


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
    if int(pos) != pos or pos < 0:
        raise ValueError(f"pos must be an integer >= 0, got {pos!r}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int) -> torch.Tensor:
    """q (B, 1, H, hd) against k/v (B, S, KV, hd), attending to slots
    [0, pos] (all S when pos >= S) -> (B, 1, H, hd) in q's dtype. ``pos``
    is a host integer.

    On CUDA q, k, v must be contiguous, of one dtype (float32 or bfloat16)
    and on one device."""
    global launches
    _check(q, k, v, pos)
    pos = int(pos)
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
    lib = _kernel()
    smem = lib.repro_decode_attention_smem_bytes(G, hd)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"G={G}, hd={hd} needs {smem} bytes of shared memory, over the {_build.SMEM_LIMIT} one block can use"
        )
    out = torch.empty_like(q)
    if B * S == 0:
        return out.zero_()
    n_valid = min(pos + 1, S)
    nsplit, chunk = split(n_valid, B * KV)
    part = (torch.empty((B, KV, nsplit, G, hd + 2), dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        int(q.dtype == torch.bfloat16), B, S, KV, G, hd, n_valid, nsplit, chunk,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: {lib.repro_cuda_error_string(err).decode()}")
    launches += 1
    return out
