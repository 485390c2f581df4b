"""Nested dict/list/tuple parameter trees, flattened in the JAX package's
order.

``jax.tree.flatten`` visits dict keys in sorted order and lists/tuples in
position order; the exchanger's bucket plan, the weight-decay masks and
the ``bucket_bytes`` grouping all follow that leaf order, so the port
flattens the same way (``tests/test_torch_exchange.py`` pins the plans
against the JAX package's).
"""
from __future__ import annotations

from typing import Any, Callable


class _Leaf:
    __slots__ = ()

    def __repr__(self):
        return "*"


LEAF = _Leaf()


def flatten(tree) -> tuple[list, Any]:
    """-> (leaves in sorted-key order, treedef)."""
    leaves: list = []

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        leaves.append(t)
        return LEAF

    treedef = rec(tree)
    # rec refers to itself through its closure cell: a cycle that would
    # keep ``leaves`` (tensors, or an engine passed as a leaf) alive until
    # the cycle collector runs. Emptying the cell breaks it.
    del rec
    return leaves, treedef


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def rec(d):
        if isinstance(d, dict):
            return {k: rec(v) for k, v in d.items()}
        if isinstance(d, (list, tuple)):
            return type(d)(rec(v) for v in d)
        return next(it)

    out = rec(treedef)
    del rec                      # break the closure's cycle (see flatten)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    ls, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(ls) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])
