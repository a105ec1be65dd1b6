"""Nested containers of tensors (the port's stand-in for ``jax.tree``).

A tree is a dict, list or tuple of trees, or a leaf (a tensor or any
other value). Dict keys keep their insertion order, so two trees built
the same way flatten in the same order.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten(tree, prefix: str = "") -> dict:
    """{"a/b/0": leaf, ...}: every leaf keyed by its path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(tree_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree) -> list:
    return list(tree_flatten(tree).values())


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
