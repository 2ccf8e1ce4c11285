"""Nested dicts of tensors (params, grads, optimizer state) as trees: the
port's stand-in for `jax.tree`. Leaves come in JAX's flatten order (dict
keys sorted), so sums over leaves add in the JAX package's order."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _rebuild(t, it):
    if isinstance(t, dict):
        return {k: _rebuild(t[k], it) for k in sorted(t)}
    return next(it)


def tree_unflatten(tree, leaves):
    """`leaves`, in `tree_leaves` order, in tree's structure. (No nested
    recursive function: its closure would be a reference cycle holding the
    leaves until the garbage collector runs.)"""
    return _rebuild(tree, iter(leaves))
