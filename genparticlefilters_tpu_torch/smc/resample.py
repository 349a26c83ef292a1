"""Resampling: multinomial, residual, stratified and systematic.

Each method draws its random numbers from ``gen``, unless the caller
passes them through a keyword: ``e``, the ``[n_out + 1]`` exponentials of
multinomial and residual (their sorted uniforms are cumulative exponential
spacings, no sort); ``v``, the ``[n_out]`` uniforms of stratified; ``u0``,
the systematic uniform. The arithmetic after the draws follows the JAX
package operation for operation, every guard kept: the ``cummax`` on the
cumsums that feed brackets, ``u >= 1e-37``, ``rc >= 1e-30`` and the
1.5/1.75 padding of residual's unused uniforms. One step departs from it:
the cumulative weights are summed in float64 (:func:`_cumw`), and the
brackets handed to the kernels are rounded to float32 after the sum.

A full state is resampled by one fused gather of every packable trace
leaf:

- systematic: pinned cumulative hit counts F -> G1 (``resample_gather_split``);
- multinomial and unsorted stratified: float brackets ``(c, u)`` -> G2
  (``resample_gather_split_u``);
- residual: ⌊n·w⌋ deterministic copies plus the remainder count G from G2
  with zero pieces and the roles swapped (``residual_F_fused``) -> F -> G1.

Sorted stratified/systematic (``sort_particles=True``) and every sub-state
take explicit parents and the explicit-parents gather G3
(``ops/gather.py``: ``gather_cols`` for particle-last pieces,
``gather_rows`` for contiguous particle-first leaves); the multinomial and
residual parents come from the merge count G4 (``ops/merge_count.py``).
Full states fold the LML before resampling and reset the weights to zero
(or to the weight/priority ratio summing to n); sub-states keep the
block's total weight, never touch the LML and record global parents.
"""

from __future__ import annotations

import torch

from ..core.batching import flatten_with_axes
from ..core.tree import tree_unflatten
from ..ops.fused_gather import resample_gather_split, resample_gather_split_u
from ..ops.gather import gather_cols, gather_rows
from ..ops.merge_count import merge_count
from ..utils.weights import (safe_softmax, apply_check, logsumexp,
                             log_float32)
from .state import ParticleFilterState, ParticleFilterSubState

__all__ = ["pf_resample", "pf_multinomial_resample", "pf_residual_resample",
           "pf_stratified_resample", "pf_systematic_resample",
           "multinomial_parents", "residual_parents", "stratified_parents",
           "systematic_parents", "stratified_F", "systematic_F",
           "multinomial_F", "residual_F", "multinomial_cu",
           "stratified_cu", "residual_F_fused", "counts_to_parents",
           "blockwise_compose"]


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
    cumsum is not (parallel scans reassociate). The pin is a fill kernel:
    assigning a Python int would copy it from the host and sync. A
    ``[K, b]`` input is pinned row by row (blockwise resampling)."""
    F = torch.clamp(cdf_hits, 0, n_out)
    F[..., -1:].fill_(n_out)
    return _cummax(F)


def _cummax(x):
    return torch.cummax(x, -1).values


def _cumw(w):
    """Cumulative weights along the last axis, summed in float64. The
    card's float32 scan reassociates: where its blocks join, a partial sum
    is off by an ulp either way, so a zero-weight particle can own a
    bracket of one ulp, n·ulp ≈ 0.006 of an output slot at n = 100K, and
    resampling picks particles it should never pick (a move-reweight step
    then gives such a particle an enormous relative weight). A float64
    scan's errors are ~1e-16: the picks go."""
    return torch.cumsum(w, -1, dtype=torch.float64)


def _brackets(w, lift: bool = True):
    """Normalized float32 brackets ``c`` from weights (any leading axes):
    the float64 cumsum, normalized, rounded to float32 and, with ``lift``,
    kept monotone by a ``cummax``. The merge count (G4) lifts dips inside
    its kernel, so its routes pass ``lift=False`` and skip that scan."""
    c = _normalized(_cumw(w)).to(torch.float32)
    return _cummax(c) if lift else c


def _normalized(c):
    """``c / max(c[-1], 1e-37)`` along the last axis: cumulative weights
    scaled to end at 1."""
    return c / torch.clamp_min(c[..., -1:], 1e-37)


def _draws(x, shape, device, draw):
    """The caller's draws ``x`` as float32 on ``device``, or ``draw()``."""
    if x is None:
        return draw()
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"draws of shape {tuple(x.shape)}, expected "
                         f"{shape}")
    return x


def _uniforms(gen, n: int, device, v=None):
    """``[n]`` Uniform(0, 1) draws from ``gen`` (or ``v``)."""
    return _draws(v, (n,), device, lambda: torch.rand(
        (n,), generator=gen, dtype=torch.float32, device=device))


def _sorted_uniforms_cum(gen, n: int, device, e=None):
    """Cumulative exponential spacings ``ce [n+1]`` from ``n + 1``
    Exponential(1) draws (or ``e``): the order statistics of n uniforms
    are ``ce[j] / ce[n]`` for j < n, with no sort. The cummax keeps them
    non-decreasing where a reassociating float32 scan is not."""
    e = _draws(e, (n + 1,), device, lambda: torch.empty(
        (n + 1,), dtype=torch.float32, device=device).exponential_(
            generator=gen))
    return _cummax(torch.cumsum(e, 0))


def stratified_F(gen, weights, n_out: int | None = None, v=None):
    """Pinned cumulative hit counts for stratified resampling: one uniform
    ``v_j`` per stratum [j/n, (j+1)/n);
    F_i = ⌊c_i⌋ + [v_⌊c_i⌋ <= c_i − ⌊c_i⌋] with c_i = n·cumsum(w)_i."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    v = _uniforms(gen, n_out, weights.device, v)
    return _stratified_hits(n_out * _cumw(weights), v, n_out)


def _stratified_hits(c, v, n_out: int):
    """Pinned stratified hit counts from ``c = n·cumsum(w)`` and the
    per-stratum uniforms ``v``: one gather instead of a search."""
    m = torch.floor(c).to(torch.int32)
    mc = torch.clamp(m, 0, n_out - 1).long()
    frac_hit = (v[mc] <= c - m.to(c.dtype)) & (m < n_out)
    F = torch.clamp(m, 0, n_out) + frac_hit.to(torch.int32)
    return _pinned_F(F, n_out)


def stratified_cu(gen, weights, n_out: int | None = None, v=None):
    """Float brackets for the fused stratified gather: normalized
    cumulative weights ``c`` and the per-stratum queries
    ``u_j = (j + v_j)/n``, ascending by construction."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    v = _uniforms(gen, n_out, weights.device, v)
    u = (torch.arange(n_out, dtype=torch.float32, device=weights.device)
         + v) / n_out
    u = torch.clamp_min(u, 1e-37)  # u = 0 would match no bracket
    return _brackets(weights), u


def systematic_F(gen, weights, n_out: int | None = None, u0=None):
    """Pinned cumulative hit counts for systematic resampling: one shared
    uniform ``u0`` (drawn from ``gen`` unless given);
    F_i = ⌊n·cumsum(w)_i − u0⌋ + 1."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    u0 = _draws(u0, (), weights.device, lambda: torch.rand(
        (), generator=gen, dtype=torch.float32, device=weights.device))
    c = n_out * _cumw(weights) - u0.to(torch.float64)
    return _pinned_F(torch.floor(c).to(torch.int32) + 1, n_out)


def multinomial_cu(gen, weights, n_out: int | None = None, e=None):
    """Float brackets for the fused multinomial gather: normalized
    cumulative weights ``c [N]`` and ascending sorted uniforms
    ``u [n_out]``. Output slot j's parent is the unique s with
    ``c[s-1] < u_j <= c[s]``, evaluated inside G2."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    ce = _sorted_uniforms_cum(gen, n_out, weights.device, e)
    # an exact-zero first uniform would match no bracket
    u = torch.clamp_min(ce[:-1] / ce[-1], 1e-37)
    return _brackets(weights), u


def multinomial_F(gen, weights, n_out: int | None = None, e=None):
    """Pinned cumulative hit counts for multinomial resampling, sort-free:
    sorted uniforms from exponential spacings, then
    ``F_i = #{j : u_j <= cumw_i}`` by the merge count G4. Clustered
    (non-decreasing) parents, the same offspring law as iid draws."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    ce = _sorted_uniforms_cum(gen, n_out, weights.device, e)
    u = ce[:-1] / ce[-1]
    F = merge_count(_brackets(weights, lift=False), u)
    return _pinned_F(F, n_out)


def _residual_split(weights, n_out: int):
    """(⌊n·w⌋ int32, remainder draw count R as a device scalar, residual
    fractions)."""
    scaled = n_out * weights
    det = torch.floor(scaled).to(torch.int32)
    n_res = n_out - torch.sum(det)
    return det, n_res, scaled - det.to(weights.dtype)


def _residual_u(ce, n_res, n_out: int):
    """The first R sorted uniforms ``ce[j] / ce[R]``, capped at 1.5; the
    unused slots padded with 1.75, above every real value and below 2.0
    (G4's contract). ``ce[R]`` is read with ``index_select``: indexing with
    a device scalar would sync the host."""
    denom = torch.index_select(ce, 0, torch.clamp(n_res, 0, n_out).reshape(1))
    j = torch.arange(n_out, device=ce.device)
    return torch.where(j < n_res, torch.clamp_max(ce[:-1] / denom, 1.5),
                       1.75)


def residual_F(gen, weights, n_out: int | None = None, e=None):
    """Pinned cumulative hit counts for residual resampling, sort-free:
    ⌊n·w⌋ deterministic offspring per particle plus merge counts (G4) of
    exactly R = n − Σ⌊n·w⌋ sorted uniforms on the residual fractions. An
    exact float32 tie u == rc counts to the left bin here and to the right
    bin in :func:`residual_F_fused`: both are valid realizations of the
    same law."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    det, n_res, resid = _residual_split(weights, n_out)
    ce = _sorted_uniforms_cum(gen, n_out, weights.device, e)
    u = _residual_u(ce, n_res, n_out)
    F_res = merge_count(_brackets(resid, lift=False), u)
    return _pinned_F(torch.cumsum(det, 0, dtype=torch.int32) + F_res, n_out)


def residual_F_fused(gen, weights, n_out: int | None = None, e=None):
    """Residual cumulative hit counts with no merge: ``F = cumsum(det) + G``
    where the remainder counts ``G_i = #{u < rc_i}`` come from one G2 pass
    with zero pieces and the roles swapped — brackets are the sorted
    residual uniforms, queries the normalized residual cumsum, and the
    parents G2 returns ARE G."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    det, n_res, resid = _residual_split(weights, n_out)
    rc = _brackets(resid)
    # a query of exactly 0.0 (zero-residual prefix) would match no bracket
    rc = torch.clamp_min(rc, 1e-30)
    ce = _sorted_uniforms_cum(gen, n_out, weights.device, e)
    u = _residual_u(ce, n_res, n_out)
    _, G = resample_gather_split_u([], u, rc)
    return _pinned_F(torch.cumsum(det, 0, dtype=torch.int32) + G, n_out)


def _F_to_parents(F, n_out: int):
    prev = torch.cat([torch.zeros((1,), dtype=F.dtype, device=F.device),
                      F[:-1]])
    return counts_to_parents(F - prev, n_out)


def multinomial_parents(gen, weights, n_out: int | None = None, e=None):
    """Multinomial ancestors in clustered (non-decreasing) order, from
    :func:`multinomial_F`."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    return _F_to_parents(multinomial_F(gen, weights, n_out, e=e), n_out)


def residual_parents(gen, weights, n_out: int | None = None, e=None):
    """Residual ancestors in clustered order, from :func:`residual_F`."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    return _F_to_parents(residual_F(gen, weights, n_out, e=e), n_out)


def _by_weight(F_fn, weights, n_out, log_priorities, sort_particles):
    """Parents from ``F_fn(w)``, optionally with the particles first sorted
    by weight (or priority), descending and stable."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    if not sort_particles:
        return _F_to_parents(F_fn(weights, n_out), n_out)
    key = weights if log_priorities is None else log_priorities
    order = torch.argsort(-key, stable=True)
    parents = _F_to_parents(F_fn(weights[order], n_out), n_out)
    return order[parents.long()].to(torch.int32)


def stratified_parents(gen, weights, n_out: int | None = None,
                       log_priorities=None, sort_particles: bool = True,
                       v=None):
    """One uniform per stratum [j/n, (j+1)/n), by default after sorting
    the particles by weight, descending."""
    return _by_weight(lambda w, m: stratified_F(gen, w, m, v=v), weights,
                      n_out, log_priorities, sort_particles)


def systematic_parents(gen, weights, n_out: int | None = None,
                       log_priorities=None, sort_particles: bool = False,
                       u0=None):
    """One shared uniform offset across all strata, optionally after
    sorting the particles by weight, descending."""
    return _by_weight(lambda w, m: systematic_F(gen, w, m, u0=u0), weights,
                      n_out, log_priorities, sort_particles)


# ---------------------------------------------------------------------------
# State-level resampling
# ---------------------------------------------------------------------------

def _pack_rows(leaves, axes, row_mode: bool = False):
    """Pack gatherable 4-byte leaves into ``[w, N]`` int32 row blocks,
    particle axis LAST, so the time-major packed storage is one block with
    no data movement. float32 rows are bit patterns, bool rows 0/1. With
    ``row_mode``, a contiguous leaf of rank >= 2 whose particle axis is 0
    becomes an ``[N, w]`` block instead (a view, where the particle-last
    block would cost a transposing copy), for G3's row gather.
    Returns (rows, meta), meta = (dtype, shape, width, particle_axis,
    by_row); width 0 marks pass-through leaves (other dtypes, Python
    values, or leaves shared across particles)."""
    rows, meta = [], []
    for leaf, ax in zip(leaves, axes):
        packable = (isinstance(leaf, torch.Tensor) and ax is not None
                    and leaf.dim() > ax and leaf.numel() > 0
                    and leaf.dtype in (torch.int32, torch.bool,
                                       torch.float32))
        if not packable:
            rows.append(None)
            meta.append((getattr(leaf, "dtype", None),
                         tuple(getattr(leaf, "shape", ())), 0, ax, False))
            continue
        by_row = (row_mode and ax == 0 and leaf.dim() >= 2
                  and leaf.is_contiguous())
        if leaf.dtype == torch.float32:
            flat = leaf.contiguous().view(torch.int32)
        elif leaf.dtype == torch.bool:
            flat = leaf.to(torch.int32)
        else:
            flat = leaf
        n = leaf.shape[ax]
        if by_row:
            rows.append(flat.reshape(n, -1))
        else:
            if ax != leaf.dim() - 1:
                flat = torch.movedim(flat, ax, -1)
            rows.append(flat.reshape(-1, n).contiguous())
        meta.append((leaf.dtype, tuple(leaf.shape), leaf.numel() // n, ax,
                     by_row))
    return rows, meta


def _seg_to_leaf(seg, dtype, shape, ax, n, by_row=False):
    """One gathered block -> the trace leaf (bit pattern back, reshape,
    particle axis restored): ``[w, n]``, or ``[n, w]`` for a row-mode
    leaf."""
    if dtype == torch.float32:
        seg = seg.view(torch.float32)
    elif dtype == torch.bool:
        seg = seg != 0
    if by_row:
        return seg.reshape((n,) + tuple(shape[1:]))
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
    for leaf, (dtype, shape, width, ax, by_row) in zip(leaves, meta):
        if width == 0:
            if (ax is None or not isinstance(leaf, torch.Tensor)
                    or leaf.dim() <= ax):
                out_leaves.append(leaf)
            else:
                out_leaves.append(torch.index_select(leaf, ax,
                                                     parents.long()))
            continue
        out_leaves.append(_seg_to_leaf(next(it), dtype, shape, ax, n,
                                       by_row))
    return out_leaves


def _gather_pieces(traces, gather):
    """Pack the packable leaves of ``traces`` into ``[w, N]`` pieces, let
    ``gather(pieces)`` return ``(outs, parents)`` — one gathered output per
    piece — and rebuild the traces. Returns ``(new_traces, parents)``."""
    leaves, axes, treedef = flatten_with_axes(traces)
    rows, meta = _pack_rows(leaves, axes)
    outs, parents = gather([r for r in rows if r is not None])
    out_leaves = _unpack_split(outs, leaves, meta, parents,
                               parents.shape[0])
    return tree_unflatten(treedef, out_leaves), parents


def _gather_traces_from_F(traces, F, n_out: int | None = None):
    """Fused resampling gather from cumulative hit counts (G1, pieces read
    in place). Returns ``(new_traces, parents)``."""
    return _gather_pieces(
        traces, lambda pieces: resample_gather_split(pieces, F, n_out=n_out))


def _gather_traces_from_cu(traces, c, u):
    """Fused resampling gather from float brackets (G2, pieces read in
    place). Returns ``(new_traces, parents)``."""
    return _gather_pieces(
        traces, lambda pieces: resample_gather_split_u(pieces, c, u))


def _gather_traces(traces, parents, clustered: bool = False):
    """Ancestry gather ``traces[parents]`` from explicit int32 parents, by
    G3: particle-last pieces (the packed step storage, per-particle
    vectors) in one ``gather_cols`` launch, contiguous particle-first
    leaves of rank >= 2 in one ``gather_rows`` launch. G3 takes parents in
    any order, so ``clustered`` (the JAX package's switch to its clustered
    kernel) is accepted and changes nothing."""
    del clustered
    parents = parents.to(torch.int32).contiguous()
    leaves, axes, treedef = flatten_with_axes(traces)
    rows, meta = _pack_rows(leaves, axes, row_mode=True)
    by_row = [mt[4] for r, mt in zip(rows, meta) if r is not None]
    pieces = [r for r in rows if r is not None]
    col_outs = iter(gather_cols([p for p, br in zip(pieces, by_row)
                                 if not br], parents))
    row_outs = iter(gather_rows([p for p, br in zip(pieces, by_row) if br],
                                parents))
    outs = [next(row_outs) if br else next(col_outs) for br in by_row]
    out_leaves = _unpack_split(outs, leaves, meta, parents,
                               parents.shape[0])
    return tree_unflatten(treedef, out_leaves)


def _new_weights_full(n, log_weights, log_priorities, parents, custom):
    """Post-resample weights of a full state."""
    if not custom:
        return torch.zeros((n,), dtype=log_weights.dtype,
                           device=log_weights.device)
    idx = parents.long()
    lw = log_weights[idx] - log_priorities[idx]
    return lw + (log_float32(n, lw.device) - logsumexp(lw))


def _new_weights_sub(n, log_weights, log_priorities, parents, custom):
    """Post-resample weights of a sub-state: the block's total weight is
    kept."""
    if not custom:
        avg = logsumexp(log_weights) - log_float32(n, log_weights.device)
        return avg.expand(n).clone()
    idx = parents.long()
    lw = log_weights[idx] - log_priorities[idx]
    return lw + (logsumexp(log_weights) - logsumexp(lw))


def blockwise_compose(gen, weights_blocks, method: str, u0=None, e=None,
                      v=None):
    """Compose the per-block offspring structures of ``K`` independent
    resamples into ONE globally clustered fused gather (the one-device path
    of ``parallel.pf_resample_blockwise``).

    Per-block parents are non-decreasing within each block and blocks are
    ascending, so the concatenation is globally clustered. Per-block scans
    are 2-D ``[K, b]`` scans along dim 1. Composition per method:

    - ``systematic``: per-block cumulative hit counts ``F_k`` plus block
      offsets, bit-identical to the per-block formulation; draws ``u0
      [K]``.
    - ``multinomial``: per-block float brackets ``(c_k, u_k)`` rescaled to
      ``(k + x)/K`` so brackets and queries stay ascending across blocks and
      every query lands inside its own block's bracket span; draws ``e
      [K, b + 1]`` (exponential spacings, as :func:`multinomial_cu`).
    - ``stratified`` (unsorted): per-block brackets exactly like
      multinomial, from draws ``v [K, b]``.
    - ``residual``: per-block deterministic ``⌊b·w⌋`` counts plus the
      remainder counted by ONE role-swapped G2 pass over the ``(k + x/2)/K``
      composition; draws ``e [K, b + 1]``.

    Draws come from ``gen`` unless passed. Returns ``("F", F_global)`` or
    ``("cu", (c_global, u_global))``.
    """
    K, b = weights_blocks.shape
    dev = weights_blocks.device
    offs = (torch.arange(K, dtype=torch.int32, device=dev) * b)[:, None]
    kf = torch.arange(K, dtype=torch.float32, device=dev)[:, None]
    invK = 1.0 / float(K)

    def spacings():
        ex = _draws(e, (K, b + 1), dev, lambda: torch.empty(
            (K, b + 1), dtype=torch.float32, device=dev).exponential_(
                generator=gen))
        return _cummax(torch.cumsum(ex, 1))

    if method == "systematic":
        u = _draws(u0, (K,), dev, lambda: torch.rand(
            (K,), generator=gen, dtype=torch.float32, device=dev))
        c = b * _cumw(weights_blocks) - u[:, None].to(torch.float64)
        F = _pinned_F(torch.floor(c).to(torch.int32) + 1, b)
        return "F", (F + offs).reshape(K * b)
    if method == "stratified":
        # unsorted stratified: per-block float brackets exactly like
        # multinomial (per-stratum draws are ascending by construction;
        # same clamp rationale as the multinomial branch)
        vv = _draws(v, (K, b), dev, lambda: torch.rand(
            (K, b), generator=gen, dtype=torch.float32, device=dev))
        u = (torch.arange(b, dtype=torch.float32, device=dev) + vv) / b
        c = _brackets(weights_blocks)
        u = torch.clamp_min(u, max(K, 2) * 2.0 ** -21)
        return "cu", (((kf + c) * invK).reshape(K * b),
                      ((kf + u) * invK).reshape(K * b))
    if method == "multinomial":
        ce = spacings()
        u = ce[:, :-1] / ce[:, -1:]
        c = _brackets(weights_blocks)
        # clamp >= K*2^-21 (not 2^-23): with ~1 ulp of margin, (k+u)*invK
        # and the block boundary k*invK can still round to EQUAL f32 values
        # for k near K at non-power-of-two K, so the strict c_prev < u
        # bracket condition would match nothing. 2^-21 leaves >= 4 ulps
        # after the rescale; matches the residual path's margin (2^-22
        # before its extra halving).
        u = torch.clamp_min(u, max(K, 2) * 2.0 ** -21)
        return "cu", (((kf + c) * invK).reshape(K * b),
                      ((kf + u) * invK).reshape(K * b))
    if method == "residual":
        scaled = b * weights_blocks
        det = torch.floor(scaled).to(torch.int32)
        n_res = b - torch.sum(det, 1, dtype=torch.int32)
        resid = scaled - det.to(weights_blocks.dtype)
        rc = _brackets(resid)
        # the same K-scaled margin as multinomial, before the halving below
        rc = torch.clamp_min(rc, max(K, 2) * 2.0 ** -22)
        ce = spacings()
        # ce[k, R_k] read with a gather: indexing with device values on the
        # host would sync
        denom = torch.gather(ce, 1, torch.clamp(n_res, 0, b).long()[:, None])
        j = torch.arange(b, device=dev)[None, :]
        u = torch.where(j < n_res[:, None],
                        torch.clamp_max(ce[:, :-1] / denom, 1.5), 1.75)
        # compose sources (u, up to 1.75) and queries (rc <= 1) with the
        # SAME monotone per-block map x -> (k + x/2)/K: ascending across
        # blocks, within-block counts preserved
        ug = ((kf + 0.5 * u) * invK).reshape(K * b)
        rcg = ((kf + 0.5 * rc) * invK).reshape(K * b)
        _, gidx = resample_gather_split_u([], ug, rcg)
        G = gidx.reshape(K, b) - offs  # per-block remainder hit counts
        F = _pinned_F(torch.cumsum(det, 1, dtype=torch.int32) + G, b)
        return "F", (F + offs).reshape(K * b)
    raise ValueError(f"no fused blockwise composition for {method!r}")


def _resample_block(gen, traces, log_weights, parent_fn, priority_fn=None,
                    F_fn=None, cu_fn=None, clustered=True):
    """Block-local resample of bare ``(traces, log_weights)`` keeping the
    block's total weight (sub-state semantics): the per-device body of a
    sharded blockwise resample. The fused gathers run when the method has
    one (``cu_fn`` -> G2, ``F_fn`` -> G1), otherwise ``parent_fn``'s
    explicit parents go through G3. Returns ``(new_traces, parents_local,
    new_log_weights)``."""
    b = log_weights.shape[0]
    custom = priority_fn is not None
    lp = priority_fn(log_weights) if custom else log_weights
    w, _ = safe_softmax(lp)
    if cu_fn is not None:
        new_traces, parents = _gather_traces_from_cu(traces, *cu_fn(gen, w))
    elif F_fn is not None:
        new_traces, parents = _gather_traces_from_F(traces, F_fn(gen, w))
    else:
        parents = parent_fn(gen, w, lp)
        new_traces = _gather_traces(traces, parents, clustered=clustered)
    new_lw = _new_weights_sub(b, log_weights, lp, parents, custom)
    return new_traces, parents, new_lw


def _resample_impl(gen, state, parent_fn, priority_fn, check, F_fn=None,
                   cu_fn=None):
    """Full states take the fused gather of ``cu_fn`` (G2) or ``F_fn``
    (G1) when the method has one; sub-states and the sorted methods take
    ``parent_fn``'s explicit parents."""
    is_sub = isinstance(state, ParticleFilterSubState)
    log_weights = state.log_weights
    n = state.n_particles
    custom = priority_fn is not None
    log_priorities = priority_fn(log_weights) if custom else log_weights
    weights, invalid = safe_softmax(log_priorities)
    apply_check(invalid, check)
    traces = state.traces
    if not is_sub and cu_fn is not None:
        new_traces, parents = _gather_traces_from_cu(traces,
                                                     *cu_fn(gen, weights))
    elif not is_sub and F_fn is not None:
        new_traces, parents = _gather_traces_from_F(traces,
                                                    F_fn(gen, weights))
    else:
        parents = parent_fn(gen, weights, log_priorities)
        new_traces = _gather_traces(traces, parents)
    if is_sub:
        new_lw = _new_weights_sub(n, log_weights, log_priorities, parents,
                                  custom)
        # sub-states never touch the LML; parents are recorded as global
        # indices so the full state's ancestry holds
        return state.scatter(
            traces=new_traces, log_weights=new_lw,
            parents=torch.index_select(state.idxs, 0, parents.long()))
    # fold the LML before resampling
    new_lml = (state.log_ml_est + logsumexp(log_weights)
               - log_float32(n, log_weights.device))
    new_lw = _new_weights_full(n, log_weights, log_priorities, parents,
                               custom)
    return ParticleFilterState(new_traces, new_lw, new_lml, parents)


def pf_multinomial_resample(gen, state, priority_fn=None, check="warn",
                            e=None):
    """Multinomial resampling of a state or sub-state. ``e`` fixes the
    ``[n + 1]`` exponential draws (otherwise drawn from ``gen``)."""
    return _resample_impl(
        gen, state, lambda g, w, lp: multinomial_parents(g, w, e=e),
        priority_fn, check, cu_fn=lambda g, w: multinomial_cu(g, w, e=e))


def pf_residual_resample(gen, state, priority_fn=None, check="warn", e=None):
    """Residual resampling of a state or sub-state. ``e`` fixes the
    ``[n + 1]`` exponential draws (otherwise drawn from ``gen``)."""
    return _resample_impl(
        gen, state, lambda g, w, lp: residual_parents(g, w, e=e),
        priority_fn, check, F_fn=lambda g, w: residual_F_fused(g, w, e=e))


def pf_stratified_resample(gen, state, priority_fn=None, check="warn",
                           sort_particles: bool = True, v=None):
    """Stratified resampling of a state or sub-state. ``v`` fixes the
    ``[n]`` per-stratum uniforms (otherwise drawn from ``gen``)."""
    return _resample_impl(
        gen, state,
        lambda g, w, lp: stratified_parents(
            g, w, log_priorities=lp, sort_particles=sort_particles, v=v),
        priority_fn, check,
        cu_fn=(None if sort_particles
               else lambda g, w: stratified_cu(g, w, v=v)))


def pf_systematic_resample(gen, state, priority_fn=None, check="warn",
                           sort_particles: bool = False, u0=None):
    """Systematic resampling of a state or sub-state. ``u0`` fixes the
    shared uniform (otherwise drawn from ``gen``)."""
    return _resample_impl(
        gen, state,
        lambda g, w, lp: systematic_parents(
            g, w, log_priorities=lp, sort_particles=sort_particles, u0=u0),
        priority_fn, check,
        F_fn=(None if sort_particles
              else lambda g, w: systematic_F(g, w, u0=u0)))


_METHODS = {
    "multinomial": pf_multinomial_resample,
    "residual": pf_residual_resample,
    "stratified": pf_stratified_resample,
    "systematic": pf_systematic_resample,
}


def pf_resample(gen, state, method: str = "multinomial", **kwargs):
    """Dispatch by method name."""
    fn = _METHODS.get(method)
    if fn is None:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    return fn(gen, state, **kwargs)
