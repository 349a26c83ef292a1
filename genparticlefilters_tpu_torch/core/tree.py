"""A minimal pytree: flatten / unflatten / map over nested containers.

The JAX package leans on ``jax.tree_util`` for three things the port still
needs: the packed step storage's column layout, the resampling flatten
(every per-particle leaf of a trace, in a fixed order), and the interop
leaf order. This module reproduces JAX's flattening order exactly, so a
trace's leaves line up one to one across the two packages:

- ``None`` is an empty subtree (no leaves);
- tuples and lists flatten in order, dicts in sorted-key order;
- an object with ``tree_flatten() -> (children, aux)`` and a classmethod
  ``tree_unflatten(aux, children)`` (the JAX protocol) is a node;
- anything else is a leaf.
"""

from __future__ import annotations

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "flatten_up_to", "TreeDef"]


class TreeDef:
    """Structure of a flattened tree: a node kind, its static aux data and
    the child structures (``kind == "leaf"`` has none)."""

    __slots__ = ("kind", "aux", "children", "n_leaves")

    def __init__(self, kind, aux, children):
        self.kind = kind
        self.aux = aux
        self.children = children
        self.n_leaves = (1 if kind == "leaf"
                         else sum(c.n_leaves for c in children))

    def __repr__(self):
        return f"TreeDef({self.kind}, leaves={self.n_leaves})"

    # structural equality: two flattenings of trees of one structure are
    # equal (layouts compare by it, and caches key on it)
    def _key(self):
        return (self.kind, self.aux, self.children)

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def _node(x, is_leaf):
    """(kind, aux, children) for a container, None for a leaf."""
    if is_leaf is not None and is_leaf(x):
        return None
    if x is None:
        return "none", None, ()
    if isinstance(x, tuple):
        return "tuple", None, x
    if isinstance(x, list):
        return "list", None, tuple(x)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return "dict", keys, tuple(x[k] for k in keys)
    if hasattr(x, "tree_flatten") and hasattr(type(x), "tree_unflatten"):
        children, aux = x.tree_flatten()
        return type(x), aux, tuple(children)
    return None


def tree_flatten(x, is_leaf=None):
    """``(leaves, treedef)`` in JAX's flattening order."""
    leaves = []

    def walk(v):
        node = _node(v, is_leaf)
        if node is None:
            leaves.append(v)
            return TreeDef("leaf", None, ())
        kind, aux, children = node
        return TreeDef(kind, aux, tuple(walk(c) for c in children))

    return leaves, walk(x)


def tree_unflatten(treedef: TreeDef, leaves):
    it = iter(leaves)

    def build(td):
        if td.kind == "leaf":
            return next(it)
        children = [build(c) for c in td.children]
        if td.kind == "none":
            return None
        if td.kind == "tuple":
            return tuple(children)
        if td.kind == "list":
            return children
        if td.kind == "dict":
            return dict(zip(td.aux, children))
        return td.kind.tree_unflatten(td.aux, children)

    out = build(treedef)
    rest = list(it)
    if rest:
        raise ValueError(f"tree_unflatten: {len(rest)} leaves left over")
    return out


def tree_leaves(x, is_leaf=None):
    return tree_flatten(x, is_leaf)[0]


def flatten_up_to(treedef: TreeDef, prefix):
    """The subtrees of ``prefix`` at the leaf positions of ``treedef``
    (JAX's ``treedef.flatten_up_to``): ``prefix`` has the structure of
    ``treedef`` down to some depth, and a leaf of ``prefix`` — ``None``
    included — stands for every leaf below its position. This is how a
    particle-axis spec tree (int or ``None`` per leaf) lines up with the
    leaves of the tree it describes."""
    out = []

    def walk(td, p):
        if td.kind == "leaf":
            out.append(p)
            return
        node = _node(p, None)
        if node is None or (p is None and td.kind != "none"):
            out.extend([p] * td.n_leaves)
            return
        kind, aux, children = node
        if len(children) != len(td.children):
            raise ValueError(f"flatten_up_to: {kind} node has "
                             f"{len(children)} children, expected "
                             f"{len(td.children)}")
        for c_td, c in zip(td.children, children):
            walk(c_td, c)

    walk(treedef, prefix)
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must share the structure)."""
    leaves, td = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map: trees differ in structure")
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
