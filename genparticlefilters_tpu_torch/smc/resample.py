"""Resampling: the systematic path.

Systematic resampling draws one shared uniform ``u0`` and turns the
normalized weights into pinned cumulative hit counts
``F_i = ⌊n·cumsum(w)_i − u0⌋ + 1`` (``F[-1] = n_out``, monotone by a
``cummax``). The fused gather G1 (ops/fused_gather.py) turns F into
parents and moves every packable trace leaf in one pass. The LML estimate
is folded before resampling, and full-state weights reset to zero (or to
the weight/priority ratio summing to n).

The other methods (multinomial, residual, stratified) and sub-states wait
for later slices.
"""

from __future__ import annotations

import torch

from ..core.batching import axes_spec
from ..core.tree import tree_flatten, tree_unflatten, flatten_up_to
from ..ops.fused_gather import resample_gather_split
from ..utils.weights import (safe_softmax, apply_check, logsumexp,
                             log_float32)
from .state import ParticleFilterState

__all__ = ["pf_resample", "pf_systematic_resample", "systematic_F",
           "counts_to_parents"]


def counts_to_parents(counts, n_out: int):
    """Per-particle offspring counts (Σ = n_out) -> the parent index vector
    [n_out] in particle order: scatter each particle's index at its first
    output slot, then forward-fill with a cummax."""
    counts = counts.to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    n = counts.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=counts.device)
    # slot n_out collects the dropped zero-count particles
    slots = torch.where(counts > 0, starts, n_out).long()
    seeded = torch.full((n_out + 1,), -1, dtype=torch.int32,
                        device=counts.device)
    seeded.scatter_reduce_(0, slots, idx, reduce="amax")
    return torch.cummax(seeded[:n_out], 0).values


def _pinned_F(cdf_hits, n_out: int):
    """Monotone cumulative hit counts with total pinned to n_out. ``F_i`` =
    number of output slots with parent <= i; output j's parent is
    ``#{i : F_i <= j}``. The cummax keeps F monotone where a float32
    cumsum is not (parallel scans reassociate)."""
    F = torch.clamp(cdf_hits, 0, n_out)
    F[-1] = n_out
    return torch.cummax(F, 0).values


def systematic_F(gen, weights, n_out: int | None = None, u0=None):
    """Pinned cumulative hit counts for systematic resampling: one shared
    uniform ``u0`` (drawn from ``gen`` unless given);
    F_i = ⌊n·cumsum(w)_i − u0⌋ + 1."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    if u0 is None:
        u0 = torch.rand((), generator=gen, dtype=torch.float32,
                        device=weights.device)
    else:
        u0 = torch.as_tensor(u0, dtype=torch.float32, device=weights.device)
    c = n_out * torch.cumsum(weights, 0) - u0
    return _pinned_F(torch.floor(c).to(torch.int32) + 1, n_out)


def _F_to_parents(F, n_out: int):
    prev = torch.cat([torch.zeros((1,), dtype=F.dtype, device=F.device),
                      F[:-1]])
    return counts_to_parents(F - prev, n_out)


# ---------------------------------------------------------------------------
# State-level resampling
# ---------------------------------------------------------------------------

def _flatten_with_axes(traces):
    """(leaves, per-leaf particle axis, treedef)."""
    leaves, treedef = tree_flatten(traces)
    return leaves, flatten_up_to(treedef, axes_spec(traces)), treedef


def _pack_rows(leaves, axes):
    """Pack gatherable 4-byte leaves into ``[w, N]`` int32 row blocks,
    particle axis LAST, so the time-major packed storage is one block with
    no data movement. float32 rows are bit patterns, bool rows 0/1.
    Returns (rows, meta), meta = (dtype, shape, width, particle_axis);
    width 0 marks pass-through leaves (other dtypes, Python values, or
    leaves shared across particles)."""
    rows, meta = [], []
    for leaf, ax in zip(leaves, axes):
        packable = (isinstance(leaf, torch.Tensor) and ax is not None
                    and leaf.dim() > ax and leaf.numel() > 0
                    and leaf.dtype in (torch.int32, torch.bool,
                                       torch.float32))
        if not packable:
            rows.append(None)
            meta.append((getattr(leaf, "dtype", None),
                         tuple(getattr(leaf, "shape", ())), 0, ax))
            continue
        if leaf.dtype == torch.float32:
            flat = leaf.contiguous().view(torch.int32)
        elif leaf.dtype == torch.bool:
            flat = leaf.to(torch.int32)
        else:
            flat = leaf
        n = leaf.shape[ax]
        if ax != leaf.dim() - 1:
            flat = torch.movedim(flat, ax, -1)
        rows.append(flat.reshape(-1, n).contiguous())
        meta.append((leaf.dtype, tuple(leaf.shape), leaf.numel() // n, ax))
    return rows, meta


def _seg_to_leaf(seg, dtype, shape, ax, n):
    """One gathered row block [w, n] -> the trace leaf (bit pattern back,
    reshape, particle axis restored)."""
    if dtype == torch.float32:
        seg = seg.view(torch.float32)
    elif dtype == torch.bool:
        seg = seg != 0
    new_shape = tuple(shape[:ax]) + tuple(shape[ax + 1:]) + (n,)
    if tuple(seg.shape) != new_shape:
        seg = seg.reshape(new_shape)
    if ax != len(shape) - 1:
        seg = torch.movedim(seg, -1, ax)
    return seg


def _unpack_split(outs, leaves, meta, parents, n):
    """Rebuild trace leaves from the per-piece gathered outputs: output i
    IS packable leaf i's gathered rows. Pass-through leaves with a particle
    axis (other dtypes) are gathered here directly."""
    out_leaves = []
    it = iter(outs)
    for leaf, (dtype, shape, width, ax) in zip(leaves, meta):
        if width == 0:
            if (ax is None or not isinstance(leaf, torch.Tensor)
                    or leaf.dim() <= ax):
                out_leaves.append(leaf)
            else:
                out_leaves.append(torch.index_select(leaf, ax,
                                                     parents.long()))
            continue
        out_leaves.append(_seg_to_leaf(next(it), dtype, shape, ax, n))
    return out_leaves


def _gather_traces_from_F(traces, F, n_out: int | None = None):
    """Fused resampling gather from cumulative hit counts: the packable
    leaves go to G1 as pieces, read in place, one gathered output per
    piece. Returns ``(new_traces, parents)``."""
    leaves, axes, treedef = _flatten_with_axes(traces)
    n_src = F.shape[0]
    m = n_src if n_out is None else int(n_out)
    rows, meta = _pack_rows(leaves, axes)
    pieces = [r for r in rows if r is not None]
    outs, parents = resample_gather_split(pieces, F, n_out=m)
    out_leaves = _unpack_split(outs, leaves, meta, parents, m)
    return tree_unflatten(treedef, out_leaves), parents


def _new_weights_full(n, log_weights, log_priorities, parents, custom):
    """Post-resample weights of a full state."""
    if not custom:
        return torch.zeros((n,), dtype=log_weights.dtype,
                           device=log_weights.device)
    idx = parents.long()
    lw = log_weights[idx] - log_priorities[idx]
    return lw + (log_float32(n, lw.device) - logsumexp(lw))


def _resample_impl(gen, state, F_fn, priority_fn, check):
    log_weights = state.log_weights
    n = state.n_particles
    custom = priority_fn is not None
    log_priorities = priority_fn(log_weights) if custom else log_weights
    weights, invalid = safe_softmax(log_priorities)
    apply_check(invalid, check)
    new_traces, parents = _gather_traces_from_F(state.traces,
                                                F_fn(gen, weights))
    # fold the LML before resampling
    new_lml = (state.log_ml_est + logsumexp(log_weights)
               - log_float32(n, log_weights.device))
    new_lw = _new_weights_full(n, log_weights, log_priorities, parents,
                               custom)
    return ParticleFilterState(new_traces, new_lw, new_lml, parents)


def pf_systematic_resample(gen, state, priority_fn=None, check="warn",
                          u0=None):
    """Systematic resampling of a full state. ``u0`` fixes the shared
    uniform (otherwise drawn from ``gen``)."""
    return _resample_impl(
        gen, state, lambda g, w: systematic_F(g, w, u0=u0), priority_fn,
        check)


_METHODS = {"systematic": pf_systematic_resample}
_LATER = ("multinomial", "residual", "stratified")


def pf_resample(gen, state, method: str = "systematic", **kwargs):
    """Dispatch by method name. Only ``"systematic"`` is ported."""
    fn = _METHODS.get(method)
    if fn is None:
        if method in _LATER:
            raise NotImplementedError(
                f"resampling method {method!r} is not ported yet")
        raise ValueError(f"Resampling method {method!r} not recognized.")
    return fn(gen, state, **kwargs)
