"""Trees of tensors: nested dicts, lists, tuples and NamedTuples.

The port's params, gradients and optimizer states are such trees, shaped
as the reference's pytrees. Leaves are visited in the reference's order:
dict keys sorted, sequence items in order, so a flattened list of leaves
lines up with ``jax.tree.leaves`` of the same tree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional


def is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node: Any) -> Optional[list]:
    """The ``(key, child)`` pairs of ``node`` in the reference's order (a
    dict's sorted keys, a sequence's indices), or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_paths(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf in the reference's order; ``path``
    the keys from the root down."""
    kids = children(tree)
    if kids is None:
        yield path, tree
        return
    for key, child in kids:
        yield from leaves_with_paths(child, path + (key,))


def _rebuild(node: Any, items) -> Any:
    if is_namedtuple(node):
        return type(node)(*items)
    return type(node)(items)


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001  (mirrors jax.tree.map)
    """The tree of ``fn(leaf, *corresponding leaves of rest)``; ``rest``
    have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [map(fn, *items) for items in zip(tree, *rest)])
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (in the order
    ``leaves(like)`` gives)."""
    it = iter(new_leaves)

    def build(node):
        kids = children(node)
        if kids is None:
            return next(it)
        built = dict((k, build(child)) for k, child in kids)
        if isinstance(node, dict):
            return {k: built[k] for k in node}
        return _rebuild(node, [built[i] for i in range(len(node))])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
