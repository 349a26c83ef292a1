"""Blockwise resampling and block exchange on one device.

Sub-state resampling semantics (keep each block's total weight, never
touch the global LML) are the specification of shard-local resampling:
:func:`pf_resample_blockwise` resamples each of ``n_blocks`` contiguous
blocks of the particle axis independently. On one device:

- with no ``priority_fn``, systematic, residual, multinomial and unsorted
  stratified take ONE fused gather for all blocks, the per-block offspring
  structures composed globally by ``smc.resample.blockwise_compose``: G1
  for systematic and residual, G2 for multinomial and unsorted stratified;
- with a ``priority_fn``, or for sorted stratified, each block's explicit
  parents are offset into one global vector and gathered by G3.

:func:`pf_rotate_blocks` and :func:`pf_shuffle_blocks` move whole blocks or
equal slices of them, the exchange that bounds the weight imbalance
between shards; on one device each is one permutation gathered by G3.

A ``mesh`` (the sharded form, one block per device) needs
``torch.distributed`` and more than one card: it is not ported yet, and
passing one raises.
"""

from __future__ import annotations

import torch

from ..smc.resample import (multinomial_parents, residual_parents,
                            stratified_parents, systematic_parents,
                            blockwise_compose, _gather_traces,
                            _gather_traces_from_F, _gather_traces_from_cu,
                            _new_weights_sub)
from ..smc.state import ParticleFilterState
from ..utils.weights import safe_softmax, logsumexp, log_float32

__all__ = ["pf_resample_blockwise", "pf_shuffle_blocks", "pf_rotate_blocks",
           "block_log_weight_imbalance"]

_PARENT_FNS = {
    "multinomial": lambda g, w, lp: multinomial_parents(g, w),
    "residual": lambda g, w, lp: residual_parents(g, w),
    "stratified": lambda g, w, lp: stratified_parents(g, w,
                                                      log_priorities=lp),
    "systematic": lambda g, w, lp: systematic_parents(g, w,
                                                      log_priorities=lp),
}

_FUSED = ("systematic", "multinomial", "residual", "stratified_unsorted")


def _check_blocks(n: int, n_blocks: int, mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (one block per device) needs the torch.distributed "
            "slice of the port, which is not ported yet; pass mesh=None "
            "for the one-device form")
    if n % n_blocks != 0:
        raise ValueError(f"n_particles={n} not divisible by {n_blocks}")


def pf_resample_blockwise(gen, state: ParticleFilterState, n_blocks: int,
                          method: str = "systematic", priority_fn=None,
                          mesh=None, sort_particles: bool | None = None
                          ) -> ParticleFilterState:
    """Resample independently inside each of ``n_blocks`` contiguous blocks
    of the particle axis, keeping each block's total weight (sub-state
    semantics); the LML estimate is untouched.

    ``sort_particles`` applies to ``method="stratified"`` only: the default
    (None/True) keeps the weight-sorted stratified draws on the per-block
    G3 route; ``False`` drops the pre-sort, the same stratified law with
    non-decreasing parents on the fused route. Every draw comes from
    ``gen``."""
    n = state.n_particles
    _check_blocks(n, n_blocks, mesh)
    b = n // n_blocks
    if method not in _PARENT_FNS:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    fused_key = method
    if method == "stratified" and sort_particles is False:
        fused_key = "stratified_unsorted"
        parent_fn = (lambda g, w, lp: stratified_parents(
            g, w, log_priorities=lp, sort_particles=False))
    else:
        parent_fn = _PARENT_FNS[method]
    custom = priority_fn is not None
    lw = state.log_weights.reshape(n_blocks, b)
    lp = priority_fn(lw) if custom else lw

    if not custom and fused_key in _FUSED:
        # ONE fused gather for all blocks: the per-block offspring
        # structures composed globally, the same offspring law as the
        # per-block route below (bit-identical for systematic)
        kind, payload = blockwise_compose(
            gen, safe_softmax(lp)[0],
            "stratified" if fused_key == "stratified_unsorted" else method)
        if kind == "cu":
            new_traces, parents = _gather_traces_from_cu(state.traces,
                                                         *payload)
        else:
            new_traces, parents = _gather_traces_from_F(state.traces,
                                                        payload)
        avg = torch.logsumexp(lw, 1) - log_float32(b, lw.device)
        return ParticleFilterState(new_traces,
                                   avg[:, None].expand(n_blocks, b)
                                   .reshape(n),
                                   state.log_ml_est, parents)

    # per-block explicit parents, offset into one vector, one G3 gather
    local, new_lw = [], []
    for k in range(n_blocks):
        w, _ = safe_softmax(lp[k])
        par = parent_fn(gen, w, lp[k])
        local.append(par.to(torch.int32) + k * b)
        new_lw.append(_new_weights_sub(b, lw[k], lp[k], par, custom))
    parents = torch.cat(local)
    return ParticleFilterState(_gather_traces(state.traces, parents),
                               torch.cat(new_lw), state.log_ml_est, parents)


def _apply_perm(state: ParticleFilterState, perm) -> ParticleFilterState:
    perm = perm.to(torch.int32).contiguous()
    return ParticleFilterState(
        _gather_traces(state.traces, perm),
        torch.index_select(state.log_weights, 0, perm.long()),
        state.log_ml_est, perm)


def pf_shuffle_blocks(state: ParticleFilterState, n_blocks: int,
                      mesh=None) -> ParticleFilterState:
    """Deterministic equal-split block transpose: new block i holds the
    ``b/K`` particles ``[j*b + i*(b/K), j*b + (i+1)*(b/K))`` of every old
    block j (requires ``n_blocks**2 | n``): new ``(i, j*c + r)`` holds old
    ``(j, i*c + r)``. One G3 gather of that permutation."""
    n = state.n_particles
    _check_blocks(n, n_blocks, mesh)
    K = n_blocks
    b = n // K
    if b % K != 0:
        raise ValueError(
            f"shuffle needs equal splits: block size {b} not divisible by "
            f"n_blocks={K}")
    perm = torch.arange(n, dtype=torch.int32,
                        device=state.log_weights.device).reshape(K, K, b // K)
    return _apply_perm(state, perm.permute(1, 0, 2).reshape(n))


def pf_rotate_blocks(state: ParticleFilterState, n_blocks: int,
                     shift: int = 1, mesh=None) -> ParticleFilterState:
    """Ring-rotate whole blocks by ``shift``: block j's particles move to
    block ``(j + shift) mod K``. One G3 gather of that permutation."""
    n = state.n_particles
    _check_blocks(n, n_blocks, mesh)
    blocks = torch.arange(n, dtype=torch.int32,
                          device=state.log_weights.device).reshape(
                              n_blocks, n // n_blocks)
    return _apply_perm(state, torch.roll(blocks, shifts=shift,
                                         dims=0).reshape(n))


def block_log_weight_imbalance(state: ParticleFilterState, n_blocks: int):
    """max − min of the per-block total log weight: the trigger diagnostic
    for a block exchange."""
    b = state.n_particles // n_blocks
    totals = logsumexp(state.log_weights.reshape(n_blocks, b))
    return torch.max(totals) - torch.min(totals)
