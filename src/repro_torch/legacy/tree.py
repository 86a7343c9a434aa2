"""Pytrees of tensors, in the reference's leaf order: nested dicts (keys
sorted), lists, tuples and ``NamedTuple``s, with ``None`` as an empty
subtree. ``legacy.checkpoint`` stores leaves in this order and
``legacy.optim`` walks parameters, gradients and moments in it."""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree) -> tuple[list, Callable]:
    """``(leaves, rebuild)``: the leaves in the reference's order, and a
    function that puts new leaves back into the same structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (ls, rb) in zip(keys, parts):
                out[k] = rb(leaves[i: i + len(ls)])
                i += len(ls)
            return out
        return [x for ls, _ in parts for x in ls], rebuild
    if isinstance(tree, (tuple, list)):
        parts = [flatten(x) for x in tree]

        def rebuild(leaves):
            out, i = [], 0
            for ls, rb in parts:
                out.append(rb(leaves[i: i + len(ls)]))
                i += len(ls)
            if hasattr(tree, "_fields"):  # a NamedTuple
                return type(tree)(*out)
            return type(tree)(out)
        return [x for ls, _ in parts for x in ls], rebuild
    if tree is None:
        return [], lambda leaves: None
    return [tree], lambda leaves: leaves[0]


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the same
    structure), into a new tree of that structure."""
    ls, rebuild = flatten(tree)
    return rebuild([fn(*xs) for xs in zip(ls, *(leaves(r) for r in rest))])
