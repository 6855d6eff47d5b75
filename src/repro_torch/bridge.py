"""Numpy crossings between the reference package and the port.

Weights and volumes cross as numpy arrays: the reference's MeshNet params
are a ``{"layers": [dict, ...], "head": dict}`` tree of arrays
(``w``/``b`` per layer, ``bn_*`` running statistics when the model has
BatchNorm). A caller holding reference arrays converts them to numpy
itself (``jax.tree.map(np.asarray, params)``); this module never touches
the reference's array type.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


def _map(tree: Any, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree: Any, device=None) -> Any:
    """A params tree of numpy arrays -> the same tree of tensors on
    ``device`` (copied; bit-equal values and the same dtypes)."""
    dev = resolve_device(device)
    return _map(tree, lambda a: torch.tensor(np.asarray(a), device=dev))


def params_to_numpy(params: Any) -> Any:
    """A params tree of tensors -> the same tree of numpy arrays."""
    return _map(params, lambda t: t.detach().cpu().numpy())


def volume_from_numpy(arr, device=None) -> torch.Tensor:
    """A channels-last volume (numpy) -> a tensor on ``device``."""
    return torch.tensor(np.asarray(arr), device=resolve_device(device))


def volume_to_numpy(vol: torch.Tensor) -> np.ndarray:
    return vol.detach().cpu().numpy()
