"""Particle filter initialization: one constrained ``generate`` over the
whole particle set, with the model's default proposal or a custom one,
optionally stratified.

A model and proposal marked ``batch_safe`` run under ONE batched
interpretation (``[N]``-leading site values); anything else runs per
particle (:func:`~..core.batching.vmap_gfi`), which reads right for any
body. With ``config.check_batched_layout`` the batched path is held
against the per-particle one's shapes (no kernel, no host read).

``dynamic`` (model-sequence SMC over differing trace types) is accepted and
ignored, as in the JAX package: every model has its own fixed trace schema
and translators move states between schemas.
"""

from __future__ import annotations

from .. import config as _config
from ..core.batching import vmap_gfi, check_batched_layout, layout_key
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


def _batch_safe(*gfs) -> bool:
    """Every generative function given (``None`` skipped) is marked
    ``batch_safe``."""
    return all(gf is None or getattr(gf, "batch_safe", False) for gf in gfs)


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
    n = int(n_particles)
    p_args = tuple(proposal_args) if proposal_args is not None else ()
    per_particle, log_nk = None, None
    if strata is not None:
        per_particle, log_nk = _per_particle_strata(gen, strata, n, layout)

    def one(stratum=None):
        base = (observations if stratum is None
                else stratum.merge(observations))
        if proposal is None:
            return model.generate(gen, model_args, base)
        prop_choices, prop_w, _ = proposal.propose(gen, p_args)
        traces, model_w = model.generate(gen, model_args,
                                         base.merge(prop_choices))
        return traces, model_w - prop_w

    if _batch_safe(model, proposal):
        with batched_interpretation(n):
            traces, ws = one(per_particle)
        if (_config.check_batched_layout and proposal is None
                and per_particle is None):
            check_batched_layout(
                traces, lambda: model.generate(gen, model_args,
                                               observations)[0],
                n, context="pf_initialize (batched)",
                key=layout_key("init", model, model_args, observations, n))
    elif per_particle is None:
        traces, ws = vmap_gfi(one, n=n, device=gen.device)
    else:
        traces, ws = vmap_gfi(one, per_particle)
    return pf_state(traces, ws if log_nk is None else ws + log_nk)
