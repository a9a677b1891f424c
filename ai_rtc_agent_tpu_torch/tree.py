"""Map a function over the leaves of a nested dict/list param tree, and
compare two such trees."""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf; dicts, lists and tuples keep their shape
    and ``None`` stays ``None`` (the JAX trees hold None for absent
    down/upsample convs)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_equal(a: dict, b: dict) -> bool:
    """Every leaf of ``a`` equal to the leaf of ``b`` at its key, bit for
    bit (``torch.equal``): two states of one structure, nested dicts with
    tensor leaves."""
    return all(tree_equal(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k])
               for k in a)
