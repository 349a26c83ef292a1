"""Particle filter initialization: one batched constrained ``generate``
over the whole particle set (the default proposal). Custom proposals and
strata wait for later slices."""

from __future__ import annotations

from ..core.choicemap import ChoiceMap
from ..core.gfi import GenFn, batched_interpretation
from .state import ParticleFilterState, pf_state

__all__ = ["pf_initialize"]


def pf_initialize(gen, model: GenFn, model_args, observations: ChoiceMap,
                  n_particles: int) -> ParticleFilterState:
    """Initialize a particle filter with ``n_particles`` constrained traces
    drawn from ``gen`` (whose device is the state's device)."""
    if not getattr(model, "batch_safe", False):
        raise NotImplementedError(
            "only batch_safe models are ported (batched interpretation); "
            "the per-particle path waits for a later slice")
    with batched_interpretation(n_particles):
        traces, ws = model.generate(gen, model_args, observations)
    return pf_state(traces, ws)
