"""Nested containers of tensors: the port's own flattener.

The reference walks its state with ``jax.tree_util``; the port walks the
same shapes of data here.  Containers are dicts (keys sorted, as JAX sorts
them), NamedTuples (fields in order), tuples and lists (by position);
``None`` is an empty subtree, as in JAX; anything else is a leaf.  A leaf's
key path joins the keys on the way to it with ``/``: ``state/U``,
``state/fad``, ``power``, ``fairness``.

>>> keys, leaves = flatten({"b": 1, "a": (2, None, [3])})
>>> keys, leaves
(['a/0', 'a/2/0', 'b'], [2, 3, 1])
>>> unflatten({"b": 0, "a": (0, None, [0])}, [20, 30, 10])
{'a': (20, None, [30]), 'b': 10}
"""
from __future__ import annotations


def _children(tree):
    """``[(key, child)]`` of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def flatten(tree, prefix: str = "") -> tuple[list[str], list]:
    """``(key paths, leaves)`` of ``tree`` in a fixed order."""
    if tree is None:
        return [], []
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    keys, leaves = [], []
    for k, child in kids:
        ks, ls = flatten(child, f"{prefix}/{k}" if prefix else str(k))
        keys += ks
        leaves += ls
    return keys, leaves


def unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in :func:`flatten`'s
    order, by ``leaves``; the leaf values of ``tree`` are never read."""
    it = iter(leaves)
    out = _rebuild(tree, it)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out


def _rebuild(tree, it):
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree has") from None
    if isinstance(tree, dict):
        return {k: _rebuild(child, it) for k, child in kids}
    rebuilt = [_rebuild(child, it) for _, child in kids]
    if hasattr(tree, "_fields"):
        return type(tree)(*rebuilt)
    return type(tree)(rebuilt)
