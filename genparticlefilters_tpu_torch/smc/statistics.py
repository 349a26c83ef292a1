"""Weighted posterior statistics over a choice address, the return value,
or a function of several addresses.

``mean`` and ``var`` are reductions over the particle axis on the device;
``proportionmap`` is a host-side diagnostic (a dict keyed by the unique
values, like a weighted countmap). On a state sharded over a particle mesh
each rank reduces its block with the globally normalized weights, and the
blocks' sums are all-gathered and added (the dicts merged), so every rank
gets the statistic of the whole particle set.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.tree import tree_flatten, tree_unflatten, flatten_up_to, tree_map
from .state import get_norm_weights, batched_choice, _mesh

__all__ = ["mean", "var", "proportionmap"]


def _front(vals, spec):
    """Each leaf of ``vals`` with its particle axis (per ``spec``) moved to
    the front; leaves shared across particles unchanged."""
    leaves, treedef = tree_flatten(vals)
    axes = flatten_up_to(treedef, spec)
    return tree_unflatten(treedef, [
        v if ax is None or ax == 0 else torch.movedim(v, ax, 0)
        for v, ax in zip(leaves, axes)])


def _values(state, addr, fn, addrs):
    """Particle-first values at ``addr`` (or of the return value when
    ``addr`` is None), mapped through ``fn`` with the values at ``addrs``
    as extra arguments."""
    if addr is None:
        traces = state.traces
        vals = _front(traces.get_retval(),
                      traces.gen_fn.retval_axes(traces))
        return vals if fn is None else fn(vals)
    vals = batched_choice(state, addr)
    if fn is not None:
        vals = fn(vals, *[batched_choice(state, a) for a in addrs])
    return vals


def _args(addr, fn):
    # mean(state, fn) convenience: a callable in the address slot
    if callable(addr) and fn is None:
        return None, addr
    return addr, fn


def _wsum_leaf(w, x):
    x = torch.as_tensor(x).to(torch.float32)
    return torch.sum(w.reshape(w.shape + (1,) * (x.dim() - 1)) * x, dim=0)


def _wsum(w, x, mesh=None):
    """Weighted sum over the particle axis, mapped over tree leaves (a
    tuple-valued return value gives a tuple of means), summed over every
    rank's block when ``mesh`` is given."""
    out = tree_map(lambda v: _wsum_leaf(w, v), x)
    if mesh is None:
        return out
    from ..parallel import mesh as pm
    return tree_map(lambda v: torch.sum(pm.all_gather(v[None], mesh), 0),
                    out)


def mean(state, addr=None, fn: Callable | None = None, *addrs):
    """Weighted empirical mean at ``addr`` (e.g. ``(t, "moving")``), of the
    return value (``addr=None``), or of ``fn`` of the values at ``addr``
    and ``addrs``; float32 device tensors."""
    addr, fn = _args(addr, fn)
    w = get_norm_weights(state)
    return _wsum(w, _values(state, addr, fn, addrs), _mesh(state))


def var(state, addr=None, fn: Callable | None = None, *addrs):
    """Weighted (uncorrected) empirical variance, in the forms of
    :func:`mean`."""
    addr, fn = _args(addr, fn)
    w = get_norm_weights(state)
    vals = _values(state, addr, fn, addrs)
    mesh = _mesh(state)
    mu = _wsum(w, vals, mesh)
    return _wsum(w, tree_map(
        lambda v, m: (torch.as_tensor(v).to(torch.float32) - m) ** 2,
        vals, mu), mesh)


def proportionmap(state, addr=None, fn: Callable | None = None, *addrs):
    """Dict mapping each unique value at ``addr`` (in the forms of
    :func:`mean`) to its total normalized weight. Reads the weights and
    values to the host."""
    addr, fn = _args(addr, fn)
    w = get_norm_weights(state).detach().cpu().numpy()
    vals = _values(state, addr, fn, addrs)
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().cpu().numpy()
    else:
        vals = np.asarray(tree_map(lambda v: v.detach().cpu().numpy(), vals))
    out = {}
    for v, wi in zip(vals.tolist(), w.tolist()):
        key = tuple(v) if isinstance(v, list) else v
        out[key] = out.get(key, 0.0) + wi
    mesh = _mesh(state)
    if mesh is None:
        return out
    import torch.distributed as dist
    parts = [None] * mesh.size
    dist.all_gather_object(parts, out, group=mesh.group)
    merged = {}
    for part in parts:
        for key, wi in part.items():
            merged[key] = merged.get(key, 0.0) + wi
    return merged
