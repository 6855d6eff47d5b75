"""Numpy crossings between the reference package and the port.

Weights and volumes cross as numpy arrays: the reference's MeshNet params
are a ``{"layers": [dict, ...], "head": dict}`` tree of arrays
(``w``/``b`` per layer, ``bn_*`` running statistics when the model has
BatchNorm). A caller holding reference arrays converts them to numpy
itself (``jax.tree.map(np.asarray, params)``); this module never touches
the reference's array type. Trees may hold NamedTuple nodes, as the
optimizer states do (``training.optimizer.AdamWState``); they cross as
the same NamedTuple type. bfloat16 leaves (numpy's ``ml_dtypes``
bfloat16, which ``torch.tensor`` refuses) cross through a 16-bit integer
view of the same bits, so they too cross bit-equal. The LM params tree
(``models/model.py``: a dict with a tuple of stacked block dicts) and its
decode caches cross the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device, tree


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; only a bf16 leaf needs it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(params: Any, device=None) -> Any:
    """A params tree of numpy arrays -> the same tree of tensors on
    ``device`` (copied; bit-equal values and the same dtypes)."""
    dev = resolve_device(device)
    return tree.map(lambda a: _tensor(a, dev), params)


def params_to_numpy(params: Any) -> Any:
    """A params tree of tensors -> the same tree of numpy arrays."""
    return tree.map(_array, params)


def volume_from_numpy(arr, device=None) -> torch.Tensor:
    """A channels-last volume (numpy) -> a tensor on ``device``."""
    return torch.tensor(np.asarray(arr), device=resolve_device(device))


def volume_to_numpy(vol: torch.Tensor) -> np.ndarray:
    return vol.detach().cpu().numpy()
