"""Wrapper of K3, the per-class Dice count kernel, and macro Dice from counts.

Counterpart of ``repro/kernels/dice.py``. The kernel is CUDA C++ for
sm_90a (``csrc/dice.cu``, whose header says how it counts and what bounds
it), loaded through ``_build``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``kernels/ref.py::dice_counts``). ``launches`` counts kernel
launches and nothing else, so a run can show that its path went through
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: kernel launches since the counter was last reset (CPU calls don't count).
launches = 0

#: the counts are int32, as the reference's are: fewer labels than this.
MAX_ELEMENTS = 2**31

_LIB = None


def _kernel():
    global _LIB
    if _LIB is None:
        lib = _build.load("dice")
        fn = lib.repro_dice_counts
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.repro_dice_max_classes.argtypes = []
        lib.repro_dice_max_classes.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def dice_counts(pred: torch.Tensor, truth: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, 3) int32 counts [intersection, |pred_c|, |truth_c|] per class of
    two label tensors of one shape (any), each int32 or int64. A label
    outside [0, C) counts nowhere.

    On CUDA both must be contiguous and on one device, and hold fewer than
    2^31 labels."""
    global launches
    if pred.shape != truth.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and truth {tuple(truth.shape)} differ in shape")
    if int(num_classes) != num_classes or num_classes < 1:
        raise ValueError(f"num_classes must be an integer >= 1, got {num_classes!r}")
    if pred.numel() >= MAX_ELEMENTS:
        raise ValueError(f"{pred.numel()} labels: the int32 counts take fewer than 2^31")
    if pred.device.type == "cpu" and truth.device.type == "cpu":
        return ref.dice_counts(pred, truth, num_classes)
    if pred.device.type != "cuda" or truth.device != pred.device:
        raise ValueError(f"no kernel for pred on {pred.device} and truth on {truth.device}")
    for name, t in (("pred", pred), ("truth", truth)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"the CUDA kernel takes int32 or int64 labels, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes contiguous tensors only ({name} is not)")
    lib = _kernel()
    if num_classes > lib.repro_dice_max_classes():
        raise ValueError(f"the CUDA kernel counts at most {lib.repro_dice_max_classes()} classes")
    out = torch.empty((num_classes, 3), dtype=torch.int32, device=pred.device)
    if pred.numel() == 0:
        return out.zero_()
    err = lib.repro_dice_counts(
        pred.data_ptr(), int(pred.dtype == torch.int64),
        truth.data_ptr(), int(truth.dtype == torch.int64),
        pred.numel(), int(num_classes), out.data_ptr(),
        torch.cuda.current_stream(pred.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dice_counts kernel launch failed: {lib.repro_cuda_error_string(err).decode()}")
    launches += 1
    return out


def dice_from_counts(counts: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Macro Dice (a float32 scalar) from (C, 3) counts; a class absent
    from both volumes scores 1."""
    inter = counts[:, 0].to(torch.float32)
    denom = (counts[:, 1] + counts[:, 2]).to(torch.float32)
    per_class = torch.where(denom == 0, 1.0, 2.0 * inter / (denom + eps))
    return torch.mean(per_class)
