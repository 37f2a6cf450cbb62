"""Nested containers of tensors, the port's stand-in for JAX pytrees.

Parameters, gradients and optimizer moments are flat ``{name: Tensor}``
dicts whose names are key paths joined by dots (``subtree`` takes the part
under a prefix); the optimizer and train states nest them in dicts, and a
few call sites pass tuples.  Leaves come in the order ``jax.tree_util`` gives:
dict keys sorted, sequences in order.
"""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` (anything not a dict, list or tuple); None
    contributes none, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over ``tree`` and trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def subtree(params: dict, prefix: str) -> dict:
    """The entries of ``params`` under ``prefix.``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}
