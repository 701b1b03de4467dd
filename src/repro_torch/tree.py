"""Nested-dict trees of tensors (the JAX package's pytrees of params,
optimizer state and checkpoints), walked in JAX's flatten order: dict keys
sorted, tuple and NamedTuple fields in order, None holding no leaf."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts of leaves)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure with ``leaves`` (in ``tree_leaves``
    order) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
