"""Particle-count resizing.

- ``pf_resize`` dispatches by method: multinomial and residual resizing to
  a new particle count, and optimal (Fearnhead–Clifford) resizing, which
  keeps every particle with ``c·w >= 1`` and stratified-resamples the rest
  so that all survivors are unique.
- ``pf_replicate`` / ``pf_dereplicate``: integer fan-out and fan-in of the
  particle axis, in contiguous or interleaved layout.
- ``pf_coalesce``: merge duplicate particles. Every slot is kept: each
  duplicate group's weight is summed onto its first occurrence (plus
  ``log(n_unique/N)``) and the other slots get ``-inf`` weight, so every
  weighted quantity matches a compacted state.
- ``pf_introduce``: append freshly generated particles, first folding any
  nonzero LML estimate into the existing weights.

Gathers: multinomial resizing is the float-bracket gather G2 with
``len(u) = n_out``; residual resizing is G2's remainder count and G1 with
``n_out``; optimal resizing, replicate, dereplicate and every other
explicit-parents gather is G3 (``smc.resample._gather_traces``). Where the
JAX package draws from a key, the draws may be passed through a keyword
(``e`` for multinomial and residual, ``u`` for optimal).
"""

from __future__ import annotations

import math

import torch

from ..core.batching import tree_concat
from ..core.choicemap import ChoiceMap
from ..core.gfi import GenFn, _mask_to
from ..core.tree import tree_leaves
from ..utils.weights import safe_softmax, apply_check, logsumexp, log_float32
from .initialize import pf_initialize
from .resample import (counts_to_parents, multinomial_cu, residual_F_fused,
                       _draws, _gather_traces, _gather_traces_from_cu,
                       _gather_traces_from_F)
from .state import ParticleFilterState

__all__ = ["pf_resize", "pf_multinomial_resize", "pf_residual_resize",
           "pf_optimal_resize", "find_inv_w_threshold", "pf_replicate",
           "pf_dereplicate", "pf_coalesce", "pf_introduce"]


def _fold_lml(state):
    return (state.log_ml_est + logsumexp(state.log_weights)
            - log_float32(state.n_particles, state.log_weights.device))


def _resize_weights(n_new, log_weights, log_priorities, parents, custom):
    """Post-resize weights: zero, or the weight/priority ratio summing to
    ``n_new``."""
    if not custom:
        return torch.zeros((n_new,), dtype=log_weights.dtype,
                           device=log_weights.device)
    idx = parents.long()
    lw = log_weights[idx] - log_priorities[idx]
    return lw + (log_float32(n_new, lw.device) - logsumexp(lw))


def _resize_impl(gen, state, n_particles, priority_fn, check, cu_fn=None,
                 F_fn=None):
    custom = priority_fn is not None
    log_priorities = (priority_fn(state.log_weights) if custom
                      else state.log_weights)
    weights, invalid = safe_softmax(log_priorities)
    apply_check(invalid, check)
    new_lml = _fold_lml(state)
    if cu_fn is not None:
        new_traces, parents = _gather_traces_from_cu(state.traces,
                                                     *cu_fn(gen, weights))
    else:
        new_traces, parents = _gather_traces_from_F(
            state.traces, F_fn(gen, weights), n_out=n_particles)
    new_lw = _resize_weights(n_particles, state.log_weights, log_priorities,
                             parents, custom)
    return ParticleFilterState(new_traces, new_lw, new_lml, parents)


def pf_multinomial_resize(gen, state, n_particles: int, priority_fn=None,
                          check="warn", e=None):
    """Multinomial resize to ``n_particles``: float brackets with
    ``n_particles`` sorted uniforms (``e``: their ``[n_particles + 1]``
    exponential draws), then G2."""
    n = int(n_particles)
    return _resize_impl(
        gen, state, n, priority_fn, check,
        cu_fn=lambda g, w: multinomial_cu(g, w, n, e=e))


def pf_residual_resize(gen, state, n_particles: int, priority_fn=None,
                       check="warn", e=None):
    """Residual resize to ``n_particles``: ``⌊n·w⌋`` copies plus the
    remainder counted by G2 (``e``: the ``[n_particles + 1]`` exponential
    draws), then G1 with ``n_out = n_particles``."""
    n = int(n_particles)
    return _resize_impl(
        gen, state, n, priority_fn, check,
        F_fn=lambda g, w: residual_F_fused(g, w, n, e=e))


def _log_inv_w_threshold(log_weights, n_particles: int):
    """log c for optimal resizing: the unique c with
    ``Σ min(1, c·wᵢ) = n_particles``.

    Entirely in log space so that the tail of a peaked weight vector (which
    underflows a float32 softmax) keeps its relative precision. Over the
    ascending sorted normalized log weights ℓ_i: A_i = #{ℓ > ℓ_i},
    log B_i = logsumexp(ℓ_{≤i}); the first i with exp(log B_i − ℓ_i) + A_i
    ≤ M gives log c = log(M − A_i) − log B_i. Indexing at that i is a
    gather, not a host read."""
    n = log_weights.shape[0]
    dev = log_weights.device
    lwn = log_weights - logsumexp(log_weights)
    ls = torch.sort(lwn).values
    logB = torch.logcumsumexp(ls, 0)
    A = torch.arange(n - 1, -1, -1, dtype=torch.float32, device=dev)
    ratio = torch.exp(logB - ls)  # >= 1; inf for -inf tail entries (skipped)
    n_check = torch.where(torch.isfinite(ls), ratio + A,
                          torch.full((), math.inf, device=dev))
    ok = n_check <= n_particles * (1.0 + 1e-5)
    first = torch.argmax(ok.to(torch.int32)).reshape(1)
    log_c = (torch.log(torch.clamp_min(n_particles - A.index_select(0, first),
                                       1e-37))
             - logB.index_select(0, first))[0]
    return torch.where(torch.any(ok), log_c,
                       log_float32(n_particles, dev))


def find_inv_w_threshold(weights, n_particles: int):
    """The inverse-weight threshold c (on top of the log-space core)."""
    return torch.exp(_log_inv_w_threshold(
        torch.log(torch.clamp_min(weights, 1e-37)), n_particles))


def pf_optimal_resize(gen, state, n_particles: int, check="warn", u=None):
    """Fearnhead–Clifford optimal resizing to ``n_particles <= N``:
    survivors are unique; kept particles keep their (shifted) weights, the
    resampled ones share the weight ``total/c``. ``u`` fixes the one
    uniform of the stratified stream (otherwise drawn from ``gen``)."""
    lw = state.log_weights
    dev = lw.device
    n_old = state.n_particles
    m = int(n_particles)
    if m > n_old:
        raise ValueError(f"optimal resize cannot grow the particle count "
                         f"({n_old} -> {m})")
    _, invalid = safe_softmax(lw)
    apply_check(invalid, check)
    lwn = lw - logsumexp(lw)
    log_c = _log_inv_w_threshold(lw, m)
    keep = (log_c + lwn) >= 0.0
    n_keep = torch.sum(keep, dtype=torch.int32)
    # stratified stream over the particles not kept, with exactly
    # m - n_keep picks; the subset is renormalized in LOG space so that
    # tail weights that underflowed globally keep their relative precision
    neg_inf = torch.full((), -math.inf, device=dev)
    lw_strat = torch.where(keep, neg_inf, lw)
    mstrat = torch.max(lw_strat)
    mstrat = torch.where(torch.isfinite(mstrat), mstrat,
                         torch.zeros((), device=dev))
    es = torch.where(keep, torch.zeros((), device=dev),
                     torch.exp(lw_strat - mstrat))
    # the stream runs in float64 (the JAX package's runs in float32): at
    # N=1M a float32 sum and cumsum on the card are off by ~1e-7 of the
    # total, i.e. ~0.03 of a pick at n_res = 250K, so the last pick can go
    # missing and the pin below then hands it to the last particle — a
    # duplicate survivor (seen on the H100 at N=1M)
    es = es.to(torch.float64)
    p = es / torch.clamp_min(torch.sum(es), 1e-300)
    cum = torch.cumsum(p, 0)
    # hit counts with the last pinned to n_res: exactly n_res picks even
    # under cumsum roundoff; the pin is a device copy, not a host write
    n_res = m - n_keep
    u = _draws(u, (), dev, lambda: torch.rand(
        (), generator=gen, dtype=torch.float32, device=dev))
    F = torch.floor(n_res.to(torch.float64) * cum - u).to(torch.int32) + 1
    F = torch.minimum(torch.clamp_min(F, 0), n_res)
    F[-1:].copy_(n_res.reshape(1))
    F = torch.cummax(F, 0).values
    counts = F - torch.cat([torch.zeros((1,), dtype=F.dtype, device=dev),
                            F[:-1]])
    res_parents = counts_to_parents(counts, m)  # first n_res entries valid

    # output layout: kept first (in index order), then the resampled picks;
    # slot m collects what is dropped
    rank_keep = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    pos_keep = torch.where(keep, rank_keep, m).long()
    src = torch.arange(n_old, dtype=torch.int32, device=dev)
    j = torch.arange(m, dtype=torch.int32, device=dev)
    pos_res = torch.where(j < n_res, n_keep + j, m).long()
    parents = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
    parents.scatter_(0, pos_res, res_parents)
    parents.scatter_(0, pos_keep, src)
    parents = parents[:m].contiguous()

    log_n_ratio = log_float32(m, dev) - log_float32(n_old, dev)
    res_lw = logsumexp(lw) - log_c + log_n_ratio
    new_lw = res_lw.expand(m + 1).clone()
    new_lw.scatter_(0, pos_keep, lw + log_n_ratio)
    new_lw = new_lw[:m].contiguous()

    return ParticleFilterState(_gather_traces(state.traces, parents), new_lw,
                               state.log_ml_est, parents)


_RESIZE_METHODS = {
    "multinomial": pf_multinomial_resize,
    "residual": pf_residual_resize,
    "optimal": pf_optimal_resize,
}


def pf_resize(gen, state, n_particles: int, method: str = "multinomial",
              **kwargs):
    """Dispatch by method name."""
    fn = _RESIZE_METHODS.get(method)
    if fn is None:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    return fn(gen, state, n_particles, **kwargs)


# ---------------------------------------------------------------------------
# Replicate / dereplicate
# ---------------------------------------------------------------------------

def _rep_idx(n: int, k: int, layout: str, device):
    base = torch.arange(n, dtype=torch.int32, device=device)
    if layout == "contiguous":
        return torch.repeat_interleave(base, k)
    if layout == "interleaved":
        return base.repeat(k)
    raise ValueError(f"unknown layout {layout!r}")


def pf_replicate(state, n_replicates: int, layout: str = "contiguous"
                 ) -> ParticleFilterState:
    """Each particle × k: contiguous blocks or interleaved stride-N copies;
    weights replicated."""
    idx = _rep_idx(state.n_particles, int(n_replicates), layout,
                   state.log_weights.device)
    return ParticleFilterState(
        _gather_traces(state.traces, idx),
        torch.index_select(state.log_weights, 0, idx.long()),
        state.log_ml_est, idx)


def pf_dereplicate(gen, state, n_replicates: int,
                   layout: str = "contiguous", method: str = "keepfirst"
                   ) -> ParticleFilterState:
    """Inverse of :func:`pf_replicate`: ``keepfirst`` (the exact inverse,
    original weights) or ``sample`` (one weighted draw per block, by the
    Gumbel-max trick as ``jax.random.categorical`` draws, with the block's
    average weight)."""
    n_old = state.n_particles
    k = int(n_replicates)
    if n_old % k != 0:
        raise ValueError(f"{n_old} particles do not split into blocks of "
                         f"{k}")
    n_new = n_old // k
    dev = state.log_weights.device
    ar = torch.arange(n_old, dtype=torch.int32, device=dev)
    if layout == "contiguous":
        blocks = ar.reshape(n_new, k)
    elif layout == "interleaved":
        blocks = ar.reshape(k, n_new).T
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if method == "keepfirst":
        idx = blocks[:, 0].contiguous()
        new_lw = torch.index_select(state.log_weights, 0, idx.long())
    elif method == "sample":
        blw = state.log_weights[blocks.long()]  # [n_new, k]
        u = torch.rand((n_new, k), generator=gen, dtype=torch.float32,
                       device=dev)
        pick = torch.argmax(blw - torch.log(-torch.log(u)), 1)
        idx = torch.gather(blocks, 1, pick[:, None])[:, 0].contiguous()
        new_lw = torch.logsumexp(blw, 1) - log_float32(k, dev)
    else:
        raise ValueError(f"unknown method {method!r}")
    return ParticleFilterState(_gather_traces(state.traces, idx), new_lw,
                               state.log_ml_est, idx)


# ---------------------------------------------------------------------------
# Coalesce
# ---------------------------------------------------------------------------

def _coalesce_key_matrix(state, by):
    n = state.n_particles
    if by is None:
        # absent values are zeroed so that only PRESENT choices distinguish
        # particles (choicemap equality); entries stored shared across
        # particles are equal everywhere and are left out
        traces = state.traces
        axes = traces.gen_fn.trace_choice_axes(traces, 0)
        leaves = []
        for key, e in sorted(traces.get_choices().entries.items(),
                             key=lambda kv: repr(kv[0])):
            v = torch.as_tensor(e.value)
            ax = axes.get(key, 0)
            if v.dim() <= ax or v.shape[ax] != n:
                continue
            if e.mask is not True:
                v = torch.where(_mask_to(e.mask, tuple(v.shape)), v,
                                torch.zeros_like(v))
            leaves.append(torch.movedim(v, ax, 0))
    else:
        leaves = [torch.as_tensor(x) for x in tree_leaves(by(state.traces))]
    cols = []
    for x in leaves:
        cols.extend(_exact_key_cols(x.reshape(n, -1)))
    return torch.cat(cols, dim=1)  # [N, D] int32


def _exact_key_cols(v):
    """Lossless int32 key columns for one ``[N, D]`` leaf: a float32 cast
    would merge int32 choices above 2**24 (and distinct float bit patterns
    that round together) into one group, so bit patterns are compared."""
    if v.dtype == torch.bool:
        return [v.to(torch.int32)]
    if v.is_floating_point():
        # -0.0 -> +0.0, so that value equality is bit equality
        v = torch.where(v == 0, torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)
        v = v.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[v.element_size()])
    elif v.dtype.is_complex:
        raise TypeError(f"pf_coalesce: unsupported key dtype {v.dtype}")
    if v.element_size() < 4:
        return [v.to(torch.int32)]
    if v.element_size() == 4:
        return [v if v.dtype == torch.int32 else v.view(torch.int32)]
    # 64-bit: two exact 32-bit halves
    v = v.to(torch.int64)
    return [(v >> 32).to(torch.int32), (v & 0xFFFFFFFF).to(torch.int32)]


def pf_coalesce(state, by=None) -> ParticleFilterState:
    """Merge duplicate particles, keeping every slot: each duplicate
    group's first occurrence carries the merged weight
    ``log Σ exp(w) + log(n_unique/N)``, the other slots get ``-inf``.
    ``by`` maps the batched traces to group keys (default: the choices)."""
    n = state.n_particles
    lw = state.log_weights
    dev = lw.device
    mat = _coalesce_key_matrix(state, by).to(dev)
    # lexicographic stable sort by columns, last column first
    order = torch.arange(n, device=dev)
    for col in range(mat.shape[1] - 1, -1, -1):
        order = order[torch.argsort(mat[order, col], stable=True)]
    sorted_rows = mat[order]
    differs = torch.any(sorted_rows[1:] != sorted_rows[:-1], dim=1)
    gid_sorted = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                            torch.cumsum(differs, 0, dtype=torch.int32)])
    gid = torch.empty((n,), dtype=torch.int32, device=dev).index_copy_(
        0, order, gid_sorted).long()
    n_unique = gid_sorted[-1] + 1
    # representative = the smallest original index of each group
    ar = torch.arange(n, device=dev)
    rep = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, ar, reduce="amin")
    # merged weight per group: log-sum-exp by a max shift and segment sums
    neg_inf = torch.full((), -math.inf, device=dev)
    mshift = torch.max(torch.where(torch.isfinite(lw), lw, neg_inf))
    mshift = torch.where(torch.isfinite(mshift), mshift,
                         torch.zeros((), device=dev))
    seg = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
        0, gid, torch.exp(lw - mshift))
    merged = torch.log(torch.clamp_min(seg, 1e-37)) + mshift
    log_ratio = torch.log(n_unique.to(torch.float32)) - log_float32(n, dev)
    new_lw = torch.where(ar == rep[gid], merged[gid] + log_ratio, neg_inf)
    return ParticleFilterState(state.traces, new_lw, state.log_ml_est,
                               torch.arange(n, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# Introduce
# ---------------------------------------------------------------------------

def pf_introduce(gen, state, observations: ChoiceMap, n_particles: int,
                 model: GenFn | None = None, model_args=None,
                 proposal: GenFn | None = None, proposal_args=None
                 ) -> ParticleFilterState:
    """Append ``n_particles`` fresh constrained particles (one batched
    ``generate`` of a ``batch_safe`` model); any nonzero LML estimate is
    folded into the existing weights first. With ``proposal``, each fresh
    particle's choices are proposed, merged over the observations and
    generated, weighted model − proposal."""
    model = model if model is not None else state.traces.gen_fn
    if model_args is None:
        model_args = state.traces.args  # shared across particles
    lw = state.log_weights + state.log_ml_est
    fresh = pf_initialize(gen, model, model_args, observations,
                          int(n_particles), proposal=proposal,
                          proposal_args=proposal_args)
    n_total = state.n_particles + int(n_particles)
    dev = lw.device
    return ParticleFilterState(
        tree_concat(state.traces, fresh.traces),
        torch.cat([lw, fresh.log_weights]),
        torch.zeros((), dtype=torch.float32, device=dev),
        torch.arange(n_total, dtype=torch.int32, device=dev))
