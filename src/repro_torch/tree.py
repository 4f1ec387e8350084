"""Nested-dict trees: the port's counterpart of ``jax.tree_util``.

Parameters, gradients and optimizer state are nested dicts of tensors.
``tree_flatten`` orders leaves with dict keys sorted, as ``jax.tree_util``
does, so a tree flattens to the same leaf order in both packages and the
exchange plan buckets the same leaves the same way.  ``tree_leaves_with_path``
names each leaf by the string ``jax.tree_util.keystr`` gives its path
(``"['attn']['k']"``), so the serving cache sorts leaves by the same keys.  Only dicts are tree
nodes; everything else (a tensor, an ``IndexedSlices``, a contribution
list) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

LEAF = "*"


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in key-sorted order, and a hashable structure (the treedef)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


# Module-level recursions: a nested function that calls itself is a
# reference cycle, which would keep every leaf it saw alive until
# Python's cyclic collector ran (gigabytes of gradients on the card).

def _flatten(node, leaves: List[Any]):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return (keys, tuple(_flatten(node[k], leaves) for k in keys))
    leaves.append(node)
    return LEAF


def _unflatten(d, it):
    if d == LEAF:
        return next(it)
    keys, children = d
    return {k: _unflatten(c, it) for k, c in zip(keys, children)}


def treedef_str(treedef) -> str:
    """The treedef as ``str(treedef)`` renders the same tree in
    ``jax.tree_util`` (``"PyTreeDef({'a': *, 'b': {'c': *}})"``), so a
    digest of it keys artifacts that both packages read."""
    return f"PyTreeDef({_render(treedef)})"


def _render(d) -> str:
    if d == LEAF:
        return LEAF
    keys, children = d
    return "{" + ", ".join(f"{k!r}: {_render(c)}"
                           for k, c in zip(keys, children)) + "}"


def tree_leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``tree_flatten``'s order; the path is
    each key's ``repr`` in brackets, outermost first."""
    out: List[Tuple[str, Any]] = []
    _with_path(tree, "", out)
    return out


def _with_path(node, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _with_path(node[k], f"{prefix}[{k!r}]", out)
    else:
        out.append((prefix, node))


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(
        leaves, *(o[0] for o in others))])


def tree_map_with_path(fn: Callable, tree, *rest) -> Any:
    """``tree_map`` whose ``fn`` takes each leaf's path (as
    ``tree_leaves_with_path`` names it) first."""
    paths = iter([p for p, _ in tree_leaves_with_path(tree)])
    return tree_map(lambda *xs: fn(next(paths), *xs), tree, *rest)
