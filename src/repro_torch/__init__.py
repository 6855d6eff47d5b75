"""PyTorch/CUDA port of the Brainchop/MeshNet system.

The package mirrors ``repro``'s layout (``core``, ``kernels``,
``telemetry``, ``serving``, ``data``) so each module has a counterpart to
be held against. It imports torch and numpy only. Volumes are
channels-last ``(B, D, H, W[, C])`` and conv weights DHWIO
``(3, 3, 3, Cin, Cout)``, as in the reference.

Device rule: every entry point takes ``device``. ``None`` means the CUDA
card; without one the entry point raises instead of running on the CPU.
Callers that want the CPU (the tests) pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> ``cuda``, which must
    exist; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU), so that host
    clocks around it measure the work and not its launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
