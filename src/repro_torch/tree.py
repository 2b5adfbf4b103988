"""Nested-dict helpers: the port's parameters, optimizer state and caches
are plain dicts of tensors (the JAX package's pytrees), walked in sorted
key order as ``jax.tree_util`` walks dicts."""
from __future__ import annotations

from typing import Any, Callable, Dict, List

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def flatten(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}``: the path names ``jax.tree_util`` gives a
    nested dict (keys joined with "/")."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}
