"""Nested dicts of tensors: the port's stand-in for ``jax.tree_util``.

The port's parameter, optimizer and checkpoint trees are nested dicts whose
leaves are tensors (or anything that is not a mapping).  Leaves are visited
in sorted key order, as JAX flattens a dict, and a leaf's path is spelt as
``jax.tree_util.keystr`` spells it (``['blocks']['pos0']['wq']``), so leaf
orders and checkpoint paths are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

__all__ = ["tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in sorted key order."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_paths(tree[k], f"{prefix}[{k!r}]")
    return out


def tree_leaves(tree: Any) -> list:
    """Every leaf, in sorted key order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf (and the leaves at the same place of ``rest``,
    trees of the same structure) in a tree of the same structure."""
    if not isinstance(tree, Mapping):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def tree_unflatten(template: Any, leaves: list) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in sorted key
    order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
