"""Wrapper of K1, the fused 3x3x3 dilated conv (+ folded BN + ReLU) kernel.

Counterpart of ``repro/kernels/dilated_conv3d.py::dilated_conv3d``. The
kernel is CUDA C++ for sm_90a (``csrc/dilated_conv3d.cu``, whose header
says how it is built and what bounds it), loaded through ``_build``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``kernels/ref.py``). ``launches`` counts kernel launches and
nothing else, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

#: shared memory one Hopper block can use (bytes).
SMEM_LIMIT = 232_448

#: kernel launches since the counter was last reset (CPU calls don't count).
launches = 0

_LIB = None


def smem_bytes(cin: int, cout: int) -> int:
    """Shared memory one block stages: weights, bias, scale and offset."""
    return (27 * cin * cout + 3 * cout) * 4


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("dilated_conv3d")
        fn = lib.repro_dilated_conv3d_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_dilated_conv3d_supports.argtypes = [ctypes.c_int]
        lib.repro_dilated_conv3d_supports.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
) -> torch.Tensor:
    """'Same' 3x3x3 dilated conv: x (B, D, H, W, Cin), w (3, 3, 3, Cin,
    Cout), b (Cout,) -> (B, D, H, W, Cout). With ``fuse_affine``:
    ``relu((conv + b) * scale + offset)``, scale 1 and offset 0 when absent.

    On CUDA every tensor must be contiguous fp32 on x's device, Cout one of
    the kernel's instantiated widths (5, 10, 18, 21), and the staged
    weights within one block's shared memory."""
    global launches
    _check_shapes(x, w, b, scale, offset, dilation)
    if x.device.type == "cpu":
        return ref.dilated_conv3d(
            x, w, b, dilation=dilation, scale=scale, offset=offset, fuse_affine=fuse_affine
        )
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
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
    lib = _kernel()
    if not lib.repro_dilated_conv3d_supports(cout):
        raise ValueError(f"the CUDA kernel is not instantiated for Cout={cout}")
    if smem_bytes(cin, cout) > SMEM_LIMIT:
        raise ValueError(
            f"Cin={cin} x Cout={cout} weights need {smem_bytes(cin, cout)} bytes of "
            f"shared memory, over the {SMEM_LIMIT} one block can use"
        )
    B, D, H, W, _ = x.shape
    out = torch.empty((B, D, H, W, cout), dtype=torch.float32, device=x.device)
    err = lib.repro_dilated_conv3d_f32(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        scale.data_ptr() if fuse_affine else None,
        offset.data_ptr() if fuse_affine else None,
        out.data_ptr(), B, D, H, W, cin, cout, int(dilation), int(fuse_affine),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"dilated_conv3d kernel launch failed: {lib.repro_cuda_error_string(err).decode()}"
        )
    launches += 1
    return out
