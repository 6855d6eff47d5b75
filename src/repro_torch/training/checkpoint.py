"""Checkpointing — counterpart of ``repro/training/checkpoint.py``, in its
on-disk format, so a checkpoint written by either package restores in the
other.

A tree (dicts, lists, tuples, NamedTuples of tensors) is flattened to
path-keyed numpy arrays (``layers/0/w``), split into bounded-size
``shard_NNNNN.npz`` files (``/`` in a key written as ``|``), each written
atomically (temporary file + rename), and described by ``manifest.json``:
``step``, ``metadata``, ``index`` (key -> shard), ``spec`` (the tree's
structure) and ``num_shards``. Restore rebuilds the exact tree, values and
dtypes bit-equal, on the device asked for; a NamedTuple node is rebuilt
as the port's class of that name in ``training/optimizer.py``. The walk
of a tree is ``repro_torch.tree``'s, leaf order and paths included.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.training import optimizer as _opt

_SEP = "/"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(node) -> dict[str, np.ndarray]:
    return {_SEP.join(map(str, path)): _to_numpy(leaf) for path, leaf in tree.leaves_with_paths(node)}


def _treedef_spec(node) -> Any:
    """JSON-able structure spec mirroring _flatten's traversal."""
    kids = tree.children(node)
    if kids is None:
        return {"__kind__": "leaf"}
    if isinstance(node, dict):
        return {"__kind__": "dict", "keys": {k: _treedef_spec(v) for k, v in kids}}
    if tree.is_namedtuple(node):
        return {
            "__kind__": "namedtuple",
            "name": type(node).__name__,
            "fields": [[f, _treedef_spec(v)] for f, (_, v) in zip(node._fields, kids)],
        }
    return {"__kind__": "list" if isinstance(node, list) else "tuple",
            "items": [_treedef_spec(v) for _, v in kids]}


def save(path: str, tree, *, step: Optional[int] = None, metadata: Optional[dict] = None,
         shard_bytes: int = 1 << 30) -> None:
    """Write checkpoint dir: manifest.json + shard_*.npz (atomic)."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    shards: list[dict[str, np.ndarray]] = [{}]
    sizes = [0]
    for k, v in flat.items():
        if sizes[-1] + v.nbytes > shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = v
        sizes[-1] += v.nbytes
    index = {}
    for i, shard in enumerate(shards):
        fname = f"shard_{i:05d}.npz"
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".npz")
        os.close(fd)
        np.savez(tmp, **{k.replace("/", "|"): v for k, v in shard.items()})
        os.replace(tmp, os.path.join(path, fname))
        for k in shard:
            index[k] = fname
    manifest = {
        "step": step,
        "metadata": metadata or {},
        "index": index,
        "spec": _treedef_spec(tree),
        "num_shards": len(shards),
    }
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def _skeleton(spec) -> Any:
    """The tree ``spec`` describes, with None for every leaf."""
    kind = spec["__kind__"]
    if kind == "leaf":
        return None
    if kind == "dict":
        return {k: _skeleton(s) for k, s in spec["keys"].items()}
    if kind in ("list", "tuple"):
        items = [_skeleton(s) for s in spec["items"]]
        return items if kind == "list" else tuple(items)
    if kind == "namedtuple":
        fields = [f for f, _ in spec["fields"]]
        # A class the port does not define comes back as a namedtuple of the
        # same name and fields.
        cls = getattr(_opt, spec["name"], None) or collections.namedtuple(spec["name"], fields)
        return cls(**{f: _skeleton(s) for f, s in spec["fields"]})
    raise ValueError(f"bad spec kind {kind}")


def restore(path: str, device=None) -> tuple[Any, dict]:
    """-> (tree of tensors on ``device``, manifest). Raises
    FileNotFoundError if absent."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat: dict[str, np.ndarray] = {}
    for i in range(manifest["num_shards"]):
        with np.load(os.path.join(path, f"shard_{i:05d}.npz")) as z:
            for k in z.files:
                flat[k.replace("|", "/")] = z[k]
    skeleton = _skeleton(manifest["spec"])
    values = [
        torch.tensor(flat[_SEP.join(map(str, path))], device=dev)
        for path, _ in tree.leaves_with_paths(skeleton)
    ]
    return tree.unflatten(skeleton, values), manifest


def latest_step_dir(root: str) -> Optional[str]:
    """The newest ``step_NNNN`` dir under ``root``, or None."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda s: int(s.split("_")[1])))
