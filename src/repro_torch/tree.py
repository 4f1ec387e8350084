"""Nested-dict trees: the port's counterpart of ``jax.tree_util``.

Parameters, gradients and optimizer state are nested dicts of tensors.
``tree_flatten`` orders leaves with dict keys sorted, as ``jax.tree_util``
does, so a tree flattens to the same leaf order in both packages and the
exchange plan buckets the same leaves the same way.  Only dicts are tree
nodes; everything else (a tensor, an ``IndexedSlices``, a contribution
list) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

LEAF = "*"


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in key-sorted order, and a hashable structure (the treedef)."""
    leaves: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return (keys, tuple(rec(node[k]) for k in keys))
        leaves.append(node)
        return LEAF

    return leaves, rec(tree)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def rec(d):
        if d == LEAF:
            return next(it)
        keys, children = d
        return {k: rec(c) for k, c in zip(keys, children)}

    out = rec(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(
        leaves, *(o[0] for o in others))])

