"""Nested dicts and lists of tensors: the port's parameter, optimizer and
checkpoint trees (the JAX package uses ``jax.tree`` for these)."""

from __future__ import annotations


def leaves(tree, *, sort_keys: bool = False, path=()):
    """(path, leaf) pairs of nested dicts, lists and tuples.  Dicts go in
    insertion order, or in sorted key order (``jax.tree``'s) with
    ``sort_keys``."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else tree
        for k in keys:
            yield from leaves(tree[k], sort_keys=sort_keys, path=path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, sort_keys=sort_keys, path=path + (i,))
    else:
        yield path, tree


def rebuild(tree, values, *, sort_keys: bool = False):
    """``tree``'s structure with its leaves taken, in the order of
    :func:`leaves`, from the iterator ``values``."""
    if isinstance(tree, dict):
        keys = sorted(tree) if sort_keys else tree
        out = {k: rebuild(tree[k], values, sort_keys=sort_keys) for k in keys}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, values, sort_keys=sort_keys)
                          for v in tree)
    return next(values)


def tree_map(fn, tree):
    """``fn`` applied to every leaf of ``tree``."""
    return rebuild(tree, iter([fn(x) for _, x in leaves(tree)]))
