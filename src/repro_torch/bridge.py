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
decode caches cross the same way, and so does the U-Net baseline's tree
(``core/unet3d.py``: DHWIO conv and up-conv kernels, as the reference's
``unet3d.init`` lays them out; ``unet3d_from_numpy`` checks each leaf's
shape against the configuration).
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


def unet3d_from_numpy(params: Any, cfg, device=None) -> Any:
    """The reference's ``unet3d.init`` tree (numpy leaves) -> the port's
    ``core/unet3d`` tree on ``device``, unchanged in layout: the port's
    ``_upconv`` reads the reference's up-conv kernel as it is. Raises
    ``ValueError`` when the tree is not ``cfg``'s (a leaf missing, extra
    or of another shape)."""
    from repro_torch.core import unet3d

    want = unet3d.leaf_shapes(cfg)
    got = {path: tuple(np.shape(a)) for path, a in tree.leaves_with_paths(params)}
    if got != want:
        wrong = sorted(set(want.items()) ^ set(got.items()), key=str)
        raise ValueError(f"not the params of {cfg}: leaves that differ (path, shape): {wrong[:4]}")
    return params_from_numpy(params, device)
