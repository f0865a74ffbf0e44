"""Nested dict/list trees of tensors, flattened in JAX's order.

``jax.tree_util`` flattens dicts by sorted key and lists in order; the
checkpoints of ``nerf_tpu`` store their leaves in that order, so the port's
parameter trees flatten the same way.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Spec = Any  # the tree with every leaf replaced by None


def tree_flatten(tree) -> Tuple[List[Any], Spec]:
    """(leaves in JAX order, spec)."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(spec: Spec, leaves) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, spec = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(spec, [fn(x, *ys) for x, *ys in zip(leaves, *others)])
