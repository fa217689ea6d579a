"""Parameter and state trees in the reference's leaf order.

The port's trees are nested dicts of tensors (parameters) inside
NamedTuples (`optimizer.AdamWState`, `train_step.TrainState`). JAX
flattens a dict in sorted key order and a NamedTuple field by field, and
that order matters twice: `optimizer.global_norm` sums the leaves in it,
and `checkpoint` names them ``leaf_{i}`` by it, so that each package
restores the other's checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable

_LEAF = object()  # a leaf's place in a tree definition


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, leaves: list):
    if isinstance(node, dict):
        return {k: _walk(node[k], leaves) for k in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*(_walk(x, leaves) for x in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(x, leaves) for x in node)
    if node is None:
        return None
    leaves.append(node)
    return _LEAF


def _build(node, it):
    if node is _LEAF:
        return next(it)
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_build(x, it) for x in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(x, it) for x in node)
    return node


# Module-level recursion, not nested closures: a closure that calls
# itself is a reference cycle, and one holding the leaves would keep a
# whole state (gigabytes on the card) alive until the garbage collector
# runs.
def flatten(tree: Any) -> tuple[list, Any]:
    """(leaves in JAX's order, the tree's definition for `unflatten`).
    None is an empty subtree, as in JAX."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def unflatten(treedef: Any, leaves) -> Any:
    """The tree of ``treedef`` holding ``leaves`` in `flatten`'s order."""
    return _build(treedef, iter(leaves))


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    flat, treedef = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
