"""Trees of tensors: the port's counterpart of the ``jax.tree_util`` calls
the reference makes.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
any other objects) as leaves; ``None`` is an empty subtree.  Leaves come
in ``jax.tree_util.tree_flatten``'s order: dict keys sorted, sequences and
NamedTuple fields in order.  So a flattened port tree lines up leaf for
leaf with the reference's tree of the same structure, which is what the
checkpoint format relies on.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _walk(node, leaves: List[Any]):
    """Appends the leaves under ``node`` to ``leaves``; returns the builder
    of ``node``'s structure from an iterator over new leaves.  A module
    function, not a closure over ``leaves``: a recursive closure is a
    reference cycle, which would keep every leaf alive until the cyclic
    collector runs."""
    if isinstance(node, dict):
        keys = sorted(node)
        subs = [_walk(node[k], leaves) for k in keys]
        return lambda it: {k: s(it) for k, s in zip(keys, subs)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        cls, subs = type(node), [_walk(v, leaves) for v in node]
        return lambda it: cls(*[s(it) for s in subs])
    if isinstance(node, (list, tuple)):
        kind, subs = type(node), [_walk(v, leaves) for v in node]
        return lambda it: kind([s(it) for s in subs])
    if node is None:
        return lambda it: None
    leaves.append(node)
    return next


def flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, build): ``build(new_leaves)`` returns a tree of the same
    structure holding ``new_leaves`` in order."""
    leaves: List[Any] = []
    rebuild = _walk(tree, leaves)
    n = len(leaves)

    def build(new_leaves):
        new_leaves = list(new_leaves)
        if len(new_leaves) != n:
            raise ValueError(f"the tree has {n} leaves, got {len(new_leaves)}")
        return rebuild(iter(new_leaves))
    return leaves, build


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    ls, build = flatten(tree)
    others = [leaves(t) for t in rest]
    return build([fn(*args) for args in zip(ls, *others)])


def describe(tree) -> str:
    """The structure as a string, leaves shown as ``*``: what a checkpoint
    manifest records in place of the reference's treedef."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        body = ", ".join(describe(v) for v in tree)
        return f"[{body}]" if isinstance(tree, list) else f"({body})"
    return "None" if tree is None else "*"
