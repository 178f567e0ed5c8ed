"""Nested parameter trees: dicts, lists and tuples of tensors.

The port keeps the JAX package's parameter and state trees as plain nested
containers.  Flattening follows ``jax.tree_util``: dict keys in sorted
order, lists and tuples in order, ``None`` an empty node; anything else
(a tensor, an array, a number, a namedtuple) is a leaf.  So a tree's leaves come in the same order in both packages, and
:func:`treedef_str` prints the structure as JAX's ``str(PyTreeDef)`` does,
which keeps checkpoint manifests 1:1.
"""
from __future__ import annotations

_LEAF = "*"


def tree_flatten(tree):
    """``(leaves, treedef)``; ``treedef`` is the tree with every leaf
    replaced by ``"*"``."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if type(t) in (list, tuple):
            return type(t)(walk(v) for v in t)
        if t is None:
            return None
        leaves.append(t)
        return _LEAF
    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if isinstance(d, dict):
            return {k: build(d[k]) for k in sorted(d)}
        if type(d) in (list, tuple):
            return type(d)(build(v) for v in d)
        if d is None:
            return None
        return next(it)
    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for ls, td in others:
        if td != treedef:
            raise ValueError("tree structures differ")
    return tree_unflatten(treedef, [fn(*xs) for xs in
                                    zip(leaves, *(ls for ls, _ in others))])


def treedef_str(treedef) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))``
    prints it."""
    def fmt(d):
        if isinstance(d, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(d[k])}"
                                   for k in sorted(d)) + "}"
        if isinstance(d, tuple):
            inner = ", ".join(fmt(v) for v in d)
            return f"({inner},)" if len(d) == 1 else f"({inner})"
        if isinstance(d, list):
            return "[" + ", ".join(fmt(v) for v in d) + "]"
        return "None" if d is None else _LEAF
    return f"PyTreeDef({fmt(treedef)})"
