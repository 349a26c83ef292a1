"""Particle filter initialization: one batched constrained ``generate``
over the whole particle set, with the model's default proposal or a custom
one, optionally stratified. The per-particle path for models that are not
``batch_safe`` waits for slice 9.

``dynamic`` (model-sequence SMC over differing trace types) is accepted and
ignored, as in the JAX package: every model has its own fixed trace schema
and translators move states between schemas.
"""

from __future__ import annotations

from ..core.choicemap import ChoiceMap
from ..core.gfi import GenFn, batched_interpretation
from ..utils.stratification import (stratum_assignment, stack_strata,
                                    gather_strata)
from ..utils.weights import log_float32
from .state import ParticleFilterState, pf_state

__all__ = ["pf_initialize"]


def _per_particle_strata(gen, strata, n, layout):
    """(per-particle constraints, log n_strata) for ``strata`` over ``n``
    particles."""
    strata = list(strata)
    assign = stratum_assignment(gen, n, len(strata), layout)
    per_particle = gather_strata(stack_strata(strata, gen.device), assign)
    return per_particle, log_float32(len(strata), gen.device)


def pf_initialize(gen, model: GenFn, model_args, observations: ChoiceMap,
                  n_particles: int, proposal: GenFn | None = None,
                  proposal_args=None, strata=None,
                  layout: str = "contiguous",
                  dynamic: bool = False) -> ParticleFilterState:
    """Initialize a particle filter with ``n_particles`` constrained traces
    drawn from ``gen`` (whose device is the state's device).

    With ``proposal``, its choices constrain the model and each weight is
    model − proposal. With ``strata`` (a list of choicemaps), every
    particle is also constrained by its stratum (``layout`` contiguous or
    interleaved) and each weight gains log(n_strata)."""
    del dynamic
    if not getattr(model, "batch_safe", False) or not (
            proposal is None or getattr(proposal, "batch_safe", False)):
        raise NotImplementedError(
            "only batch_safe models and proposals are ported (batched "
            "interpretation); the per-particle path waits for slice 9")
    with batched_interpretation(n_particles):
        if strata is not None:
            per_particle, log_nk = _per_particle_strata(
                gen, strata, n_particles, layout)
            base = per_particle.merge(observations)
        else:
            base, log_nk = observations, None
        if proposal is None:
            traces, ws = model.generate(gen, model_args, base)
        else:
            p_args = tuple(proposal_args) if proposal_args is not None else ()
            prop_choices, prop_w, _ = proposal.propose(gen, p_args)
            traces, model_w = model.generate(gen, model_args,
                                             base.merge(prop_choices))
            ws = model_w - prop_w
    return pf_state(traces, ws if log_nk is None else ws + log_nk)
