"""Trees of tensors: the port's counterpart of ``jax.tree``.

A tree is a dict, a tuple or list, or a leaf. :func:`leaves` flattens it in
the reference's order (``jax.tree_util.tree_leaves``: dict keys sorted,
sequences in order), :func:`rebuild` puts leaves back in that order, and
:func:`tree_map` applies a function leaf by leaf to trees of one structure.
A list comes back as a tuple.
"""

from __future__ import annotations

__all__ = ["leaves", "rebuild", "tree_map"]


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` of the trees' leaves, one position at a time, in the first
    tree's structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def rebuild(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in the flattening
    order, by ``new_leaves``."""
    it = iter(new_leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v) for v in t)
        return next(it)
    return walk(tree)
