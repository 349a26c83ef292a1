"""Particle filter update: propagate every particle one step and reweight.
One dispatcher covers the JAX package's forms:

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

Works on full states and on :class:`ParticleFilterSubState` views. When
the model and every generative function a translator invokes are marked
``batch_safe``, the update runs under ONE batched interpretation of the
whole particle set (held against the per-particle shapes by the
``config.check_batched_layout`` guard); otherwise, and whenever strata
meet a translator, it runs per particle
(:func:`~..core.batching.vmap_gfi`).
"""

from __future__ import annotations

import contextlib
import copy

from .. import config as _config
from ..core.batching import vmap_gfi, check_batched_layout, layout_key
from ..core.choicemap import ChoiceMap, EMPTY
from ..core.gfi import GenFn, batched_interpretation
from ..core.packed import StepStorage, owned, storage_of
from .initialize import _per_particle_strata, _batch_safe
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
    if isinstance(translator, ExtendingTraceTranslator):
        qs = (translator.q_forward,)
    elif isinstance(translator, UpdatingTraceTranslator):
        qs = (translator.q_forward, translator.q_backward)
    elif isinstance(translator, GeneralTraceTranslator):
        qs = (translator.q_forward, translator.q_backward,
              translator.new_model)
    else:
        return False
    return _batch_safe(model_gf, *qs)


def _with_stratum(translator, stratum):
    """A copy of ``translator`` whose new observations also hold a
    particle's stratum (the observations win where both constrain an
    address)."""
    out = copy.copy(translator)
    out.new_observations = stratum.merge(translator.new_observations)
    return out


def _donated(state, donate: bool):
    """The scope in which the model's update owns the packed stores that
    ``state``'s traces hold at their top (an Unfold's), ``state`` their
    donating tree (``core/packed.py`` :func:`owned`). No scope for a view
    or without ``donate``."""
    if not donate or isinstance(state, ParticleFilterSubState):
        return contextlib.nullcontext()
    inner = state.traces.inner
    stores = inner.values() if isinstance(inner, dict) else ()
    return owned({storage_of(st.mat) for st in stores
                  if isinstance(st, StepStorage) and st.mat is not None},
                 state)


def pf_update(gen, state, new_args=None, argdiffs=None,
              observations: ChoiceMap = EMPTY,
              proposal: GenFn | None = None, proposal_args=None,
              bwd_proposal: GenFn | None = None, bwd_args=None,
              transform=None, translator=None, strata=None,
              layout: str = "interleaved", check: bool | None = None,
              prev_observations: ChoiceMap = EMPTY, translator_kwargs=None,
              donate: bool = False):
    """Propagate every particle one step and reweight. Returns a new
    state (the full state when given a view).

    ``donate=True`` is the caller's promise that ``state`` is dead after
    the call (a loop that rebinds it), as with ``device_cond(donate=)``:
    the model's batched update may then write the new steps of the packed
    trace store into the incoming store in place where
    ``core/packed.py`` ``may_overwrite`` allows it, instead of into a copy
    of the whole store. The default leaves ``state`` untouched. Views,
    translators and the per-particle interpretation ignore it."""
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

    if (strata is not None and translator is not None
            and not isinstance(translator, (ExtendingTraceTranslator,
                                            UpdatingTraceTranslator))):
        raise ValueError(
            "strata reach a translator through its new observations: they "
            "combine with extending and updating translators only")
    per_particle, log_nk = None, None
    if strata is not None:
        per_particle, log_nk = _per_particle_strata(gen, strata, n, layout)

    if translator is not None:
        tkw = dict(translator_kwargs or {})
        if check is not None:
            tkw["check"] = check
        if (isinstance(translator, UpdatingTraceTranslator)
                and prev_observations is not EMPTY):
            tkw["prev_observations"] = prev_observations
        if per_particle is None and _translator_batch_safe(traces.gen_fn,
                                                           translator):
            with batched_interpretation(n):
                new_traces, ws = translator(gen, traces, **tkw)
            if _config.check_batched_layout:
                check_batched_layout(
                    new_traces, lambda tr: translator(gen, tr, **tkw)[0], n,
                    context="pf_update (batched translator)",
                    eval_args=(traces,),
                    key=layout_key("translator", translator, traces, tkw,
                                   n))
        elif per_particle is None:
            new_traces, ws = vmap_gfi(
                lambda tr: translator(gen, tr, **tkw), traces)
        else:
            new_traces, ws = vmap_gfi(
                lambda tr, stratum: _with_stratum(translator, stratum)(
                    gen, tr, **tkw), traces, per_particle)
        lw = log_weights + ws
        return scatter(new_traces, lw if log_nk is None else lw + log_nk)

    if new_args is None:
        raise ValueError("pf_update requires new_args (or a translator)")

    def one(tr, stratum=None):
        constraints = (observations if stratum is None
                       else stratum.merge(observations))
        new_tr, w, _, discard = tr.gen_fn.update(gen, tr, new_args, argdiffs,
                                                 constraints)
        return new_tr, w, discard

    if getattr(traces.gen_fn, "batch_safe", False):
        with batched_interpretation(n), _donated(state, donate):
            new_traces, ws, discard = one(traces, per_particle)
        if _config.check_batched_layout and per_particle is None:
            check_batched_layout(
                new_traces, lambda tr: one(tr)[0], n,
                context="pf_update (batched)", eval_args=(traces,),
                key=layout_key("update", traces, new_args, argdiffs,
                               observations, n))
    elif per_particle is None:
        new_traces, ws, discard = vmap_gfi(one, traces)
    else:
        new_traces, ws, discard = vmap_gfi(one, traces, per_particle)
    _check_no_discard(discard, True if check is None else check)
    lw = log_weights + ws
    return scatter(new_traces, lw if log_nk is None else lw + log_nk)
