"""Canned SMC filter: the README loop as a reusable function.

:func:`run_particle_filter` runs a state-space particle filter with
ESS-triggered resampling (and optional rejuvenation): a Python loop over
the steps, with the ESS trigger a Python ``if`` on a device scalar — one
host synchronisation per step.
"""

from __future__ import annotations

from typing import Callable

from ..core.gfi import GenFn, NoChange, Extend
from .state import ParticleFilterState, effective_sample_size
from .initialize import pf_initialize
from .update import pf_update
from .resample import pf_resample

__all__ = ["run_particle_filter"]


def run_particle_filter(gen, model: GenFn, t_max: int, n_particles: int,
                        step_args_fn: Callable,
                        obs_fn: Callable,
                        ess_frac: float = 0.5,
                        resample_method: str = "systematic",
                        rejuvenate_fn: Callable | None = None,
                        argdiffs=None) -> ParticleFilterState:
    """Generic SSM particle filter, every random number drawn from
    ``gen``.

    - ``step_args_fn(t)``: model args for active length t+1
    - ``obs_fn(t)``: dense ChoiceMap constraining step t
    - ``rejuvenate_fn(gen, state, t)``: optional MCMC rejuvenation
    - ``argdiffs``: forwarded to pf_update; defaults to the incremental
      ``(Extend(1), NoChange...)`` promise.

    The JAX package's unused ``init_args`` parameter is left out.
    """
    state = pf_initialize(gen, model, step_args_fn(0), obs_fn(0),
                          n_particles)
    n_args = len(step_args_fn(0))
    diffs = argdiffs if argdiffs is not None else (
        (Extend(1),) + tuple(NoChange() for _ in range(n_args - 1)))
    for t in range(1, t_max):
        if bool(effective_sample_size(state) < ess_frac * n_particles):
            state = pf_resample(gen, state, resample_method, check=False)
            if rejuvenate_fn is not None:
                state = rejuvenate_fn(gen, state, t)
        state = pf_update(gen, state, step_args_fn(t), diffs, obs_fn(t),
                          check=False)
    return state
