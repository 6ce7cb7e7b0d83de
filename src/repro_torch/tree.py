"""Minimal pytree helpers over nested dicts, tuples, lists and NamedTuples.

The port keeps parameters and optimizer state as plain containers (the JAX
pytree's structure), so it needs the few ``jax.tree_util`` operations the
reference leans on.  Dict keys are visited in sorted order, as JAX does;
``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable


def _flatten(node: Any, leaves: list) -> Callable:
    """Append ``node``'s leaves to ``leaves``; return its rebuilder.  A
    module-level function: a nested one that calls itself is a reference
    cycle, which would keep ``leaves`` (the tensors) alive until Python's
    cyclic collector happens to run."""
    if isinstance(node, dict):
        keys = sorted(node)
        subs = [_flatten(node[k], leaves) for k in keys]
        return lambda it: {k: s(it) for k, s in zip(keys, subs)}
    if isinstance(node, (tuple, list)):
        subs = [_flatten(v, leaves) for v in node]
        cls = type(node)
        if hasattr(node, "_fields"):                # NamedTuple
            return lambda it: cls(*[s(it) for s in subs])
        return lambda it: cls(s(it) for s in subs)
    if node is None:
        return lambda it: None
    leaves.append(node)
    return lambda it: next(it)


def tree_flatten(tree: Any) -> tuple[list, Callable]:
    """``(leaves, rebuild)``: ``rebuild(leaves)`` restores the structure."""
    leaves: list = []
    build = _flatten(tree, leaves)
    return leaves, lambda new_leaves: build(iter(new_leaves))


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def tree_map(f: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``f`` leafwise over trees of one structure."""
    leaves, rebuild = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map: trees differ in structure")
    return rebuild([f(*xs) for xs in zip(leaves, *others)])


def tree_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` in flatten order; a path is a tuple of keys."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]
