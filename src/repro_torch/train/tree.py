"""Trees of tensors as dicts, lists and tuples: the port's stand-in for
``jax.tree``. Leaves are flattened in JAX's order (dict keys sorted, lists
and tuples in order), so that a tree's leaf list and a checkpoint's
manifest match the reference's for the same tree; anything that is not
a dict, list or tuple is a leaf."""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)``; :func:`unflatten` inverts it."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(node, leaves: list):
    # module-level recursion: a nested recursive closure would sit in a
    # reference cycle with the leaves, keeping them (gradients,
    # accumulators) alive until the cyclic collector runs
    if isinstance(node, dict):
        return ("dict", [(k, _walk(node[k], leaves)) for k in sorted(node)])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, [_walk(v, leaves) for v in node])
    leaves.append(node)
    return None


def unflatten(treedef, leaves):
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _build(node, it):
    if node is None:
        return next(it)
    kind, children = node
    if kind == "dict":
        return {k: _build(c, it) for k, c in children}
    out = [_build(c, it) for c in children]
    return tuple(out) if kind == "tuple" else out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    flat, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in flat])
