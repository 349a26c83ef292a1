"""Particle-axis specs for batched traces (time-major layout).

Where the particle axis sits in each stored trace leaf is a layout choice
that every resampling gather has to know. Each generative function states
it through ``GenFn.trace_axes``: :class:`~.combinators.Unfold` keeps its
packed step storage time-major (``mat [T*R, N]``, particle axis 1) and its
active length ``t`` shared (spec ``None``); per-particle scores and carries
sit at axis 0. :func:`axes_spec` gathers those specs for a whole tree.

:func:`tree_take` and :func:`tree_put` gather and scatter a whole tree
along each leaf's particle axis (sub-state views, smc/state.py);
:func:`tree_concat` joins two trees along it (``pf_introduce``).

Only the batched form is ported; the per-particle (vmapped) form waits.
"""

from __future__ import annotations

import torch

from .gfi import Trace
from .tree import tree_map, tree_flatten, tree_unflatten, flatten_up_to

__all__ = ["axes_spec", "gen_spec", "const_spec", "spec_n",
           "flatten_with_axes", "tree_take", "tree_put", "tree_concat"]


def _leaf_axis(x, axis, n=None):
    """Shape-aware spec for one leaf: a leaf that cannot hold the particle
    axis at ``axis`` — rank too small, or (when the particle count ``n`` is
    known) the wrong extent there — is SHARED across particles (``None``).
    Non-tensor leaves (Python ints) are always shared."""
    if axis is None or not isinstance(x, torch.Tensor):
        return None
    if x.dim() <= axis:
        return None
    if n is not None and x.shape[axis] != n:
        return None
    return axis


def spec_n(score, axis):
    """The particle count implied by a trace's per-particle score leaf, or
    None when the score carries no particle axis."""
    s = tuple(score.shape)
    return s[axis] if len(s) > axis else None


def const_spec(subtree, axis, n=None):
    """Spec tree with every leaf at ``axis`` (shape-aware, no Trace
    recursion)."""
    return tree_map(lambda x: _leaf_axis(x, axis, n), subtree)


def gen_spec(subtree, axis, n=None):
    """Spec for an arbitrary container: leaves at ``axis`` (shape-aware);
    nested traces defer to their generative function's ``trace_axes``."""
    return tree_map(
        lambda x: (x.gen_fn.trace_axes(x, axis) if isinstance(x, Trace)
                   else _leaf_axis(x, axis, n)),
        subtree, is_leaf=lambda x: isinstance(x, Trace))


def axes_spec(obj, axis: int = 0):
    """Per-leaf particle-axis spec for any tree that may contain traces.
    Top-level traces use the SMC convention that their args are one shared
    tuple (``args_shared=True``)."""
    return tree_map(
        lambda x: (x.gen_fn.trace_axes(x, axis, args_shared=True)
                   if isinstance(x, Trace) else axis),
        obj, is_leaf=lambda x: isinstance(x, Trace))


def flatten_with_axes(tree):
    """(leaves, per-leaf particle axis, treedef) of any tree that may
    contain traces."""
    leaves, treedef = tree_flatten(tree)
    return leaves, flatten_up_to(treedef, axes_spec(tree)), treedef


def _batched(leaf, ax) -> bool:
    return (ax is not None and isinstance(leaf, torch.Tensor)
            and leaf.dim() > ax)


def tree_take(tree, idx):
    """Gather ``leaf[..., idx, ...]`` along each leaf's particle axis.
    Leaves shared across particles pass through untouched."""
    leaves, axes, treedef = flatten_with_axes(tree)
    idx = torch.as_tensor(idx).long()
    return tree_unflatten(treedef, [
        torch.index_select(l, ax, idx.to(l.device)) if _batched(l, ax) else l
        for l, ax in zip(leaves, axes)])


def tree_put(full, block, idx):
    """``full`` with ``block`` written at particle indices ``idx`` along
    each leaf's particle axis, out of place: ``full`` is not modified."""
    leaves, axes, treedef = flatten_with_axes(full)
    blocks = tree_flatten(block)[0]
    if len(blocks) != len(leaves):
        raise ValueError("tree_put: block and full differ in structure")
    idx = torch.as_tensor(idx).long()
    return tree_unflatten(treedef, [
        f.index_copy(ax, idx.to(f.device), b) if _batched(f, ax) else f
        for f, ax, b in zip(leaves, axes, blocks)])


def tree_concat(a, b):
    """Concatenate two batched trees of the same structure along each
    leaf's particle axis (the axes of ``a``). Leaves shared across
    particles keep ``a``'s value."""
    leaves, axes, treedef = flatten_with_axes(a)
    others = tree_flatten(b)[0]
    if len(others) != len(leaves):
        raise ValueError("tree_concat: the trees differ in structure")
    return tree_unflatten(treedef, [
        torch.cat([x, y], dim=ax) if _batched(x, ax) else x
        for x, ax, y in zip(leaves, axes, others)])
