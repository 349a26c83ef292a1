"""Particle filter update: propagate every particle one step and reweight,
under ONE batched interpretation of the whole particle set. One
dispatcher covers the JAX package's forms:

- ``pf_update(gen, state, new_args, argdiffs, observations)``: the
  model's default proposal;
- ``..., proposal=, proposal_args=[, transform=]``: an
  :class:`ExtendingTraceTranslator`;
- ``..., proposal=, bwd_proposal=, bwd_args=[, transform=]``: an
  :class:`UpdatingTraceTranslator` (Del Moral SMC, or SMCP³ with a
  transform);
- ``pf_update(gen, state, translator=...)``: any translator;
- any of the above with ``strata=``: a stratified update (default layout
  interleaved), each weight + log(n_strata).

Works on full states and on :class:`ParticleFilterSubState` views. The
per-particle path (models or proposals that are not ``batch_safe``)
waits for slice 9.
"""

from __future__ import annotations

import copy

from ..core.choicemap import ChoiceMap, EMPTY
from ..core.gfi import GenFn, batched_interpretation
from .initialize import _per_particle_strata
from .state import ParticleFilterSubState
from .translate import (ExtendingTraceTranslator, UpdatingTraceTranslator,
                        GeneralTraceTranslator, _check_no_discard)

__all__ = ["pf_update"]


def _block(state):
    """``(traces, log_weights, n, scatter)`` of a full state or a view:
    ``scatter(traces, log_weights)`` returns the full state with the
    block's values written back (particles outside a view unchanged)."""
    if isinstance(state, ParticleFilterSubState):
        def scatter(traces, lw):
            return state.scatter(traces=traces, log_weights=lw)
    else:
        def scatter(traces, lw):
            return state.replace(traces=traces, log_weights=lw)
    return state.traces, state.log_weights, state.n_particles, scatter


def _translator_batch_safe(model_gf, translator) -> bool:
    """A translator runs under ONE batched interpretation when it is one
    of the known classes and the model and every generative function it
    invokes are ``batch_safe``."""
    if not getattr(model_gf, "batch_safe", False):
        return False
    if isinstance(translator, ExtendingTraceTranslator):
        qs = (translator.q_forward,)
    elif isinstance(translator, UpdatingTraceTranslator):
        qs = (translator.q_forward, translator.q_backward)
    elif isinstance(translator, GeneralTraceTranslator):
        qs = (translator.q_forward, translator.q_backward,
              translator.new_model)
    else:
        return False
    return all(q is None or getattr(q, "batch_safe", False) for q in qs)


def _stratified_translator(gen, translator, strata, n, layout):
    """``(translator, log n_strata)``: a copy of ``translator`` whose new
    observations also hold each particle's stratum (the observations win
    where both constrain an address)."""
    if not isinstance(translator, (ExtendingTraceTranslator,
                                   UpdatingTraceTranslator)):
        raise NotImplementedError(
            "strata combine with extending and updating translators only")
    per_particle, log_nk = _per_particle_strata(gen, strata, n, layout)
    out = copy.copy(translator)
    out.new_observations = per_particle.merge(translator.new_observations)
    return out, log_nk


def pf_update(gen, state, new_args=None, argdiffs=None,
              observations: ChoiceMap = EMPTY,
              proposal: GenFn | None = None, proposal_args=None,
              bwd_proposal: GenFn | None = None, bwd_args=None,
              transform=None, translator=None, strata=None,
              layout: str = "interleaved", check: bool | None = None,
              prev_observations: ChoiceMap = EMPTY, translator_kwargs=None):
    """Propagate every particle one step and reweight. Returns a new
    state (the full state when given a view)."""
    traces, log_weights, n, scatter = _block(state)

    if translator is None and proposal is not None and bwd_proposal is None:
        translator = ExtendingTraceTranslator(
            p_new_args=new_args, p_argdiffs=argdiffs,
            new_observations=observations, q_forward=proposal,
            q_forward_args=tuple(proposal_args or ()), transform=transform)
    elif translator is None and bwd_proposal is not None:
        translator = UpdatingTraceTranslator(
            p_new_args=new_args, p_argdiffs=argdiffs,
            new_observations=observations, q_forward=proposal,
            q_forward_args=tuple(proposal_args or ()),
            q_backward=bwd_proposal, q_backward_args=tuple(bwd_args or ()),
            transform=transform)

    if translator is not None:
        if not _translator_batch_safe(traces.gen_fn, translator):
            raise NotImplementedError(
                "only batch_safe models and translators are ported (batched "
                "interpretation); the per-particle path waits for slice 9")
        tkw = dict(translator_kwargs or {})
        if check is not None:
            tkw["check"] = check
        if (isinstance(translator, UpdatingTraceTranslator)
                and prev_observations is not EMPTY):
            tkw["prev_observations"] = prev_observations
        with batched_interpretation(n):
            log_nk = None
            if strata is not None:
                translator, log_nk = _stratified_translator(
                    gen, translator, strata, n, layout)
            new_traces, ws = translator(gen, traces, **tkw)
        lw = log_weights + ws
        return scatter(new_traces, lw if log_nk is None else lw + log_nk)

    if new_args is None:
        raise ValueError("pf_update requires new_args (or a translator)")
    if not getattr(traces.gen_fn, "batch_safe", False):
        raise NotImplementedError(
            "only batch_safe models are ported (batched interpretation); "
            "the per-particle path waits for slice 9")
    with batched_interpretation(n):
        constraints, log_nk = observations, None
        if strata is not None:
            per_particle, log_nk = _per_particle_strata(gen, strata, n,
                                                        layout)
            constraints = per_particle.merge(observations)
        new_traces, ws, _, discard = traces.gen_fn.update(
            gen, traces, new_args, argdiffs, constraints)
    _check_no_discard(discard, True if check is None else check)
    lw = log_weights + ws
    return scatter(new_traces, lw if log_nk is None else lw + log_nk)
