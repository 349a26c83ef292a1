"""Canned SMC drivers: the README loop as reusable functions.

- :func:`run_particle_filter`: a state-space particle filter with
  ESS-triggered resampling (and optional rejuvenation);
- :func:`tempered_smc`: SMC over a model *sequence* (annealing), each
  move an ``update`` to new model arguments, with ESS-triggered
  resampling and optional rejuvenation.

Both are Python loops over the steps, with the ESS trigger a Python ``if``
on a device scalar: one host synchronisation per step. Given a particle
``mesh`` (parallel/mesh.py), :func:`run_particle_filter` runs each rank's
block of the particles: the ESS is global, so every rank takes the same
branch, and the resample is the exact global one. Each phase runs in
a ``torch.profiler`` span: ``{span_prefix}.initialize``, ``.ess_check``,
``.resample``, ``.rejuvenate`` and ``.update``; each model's wrapper
passes its own prefix (``sv``, ``tm``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.choicemap import EMPTY
from ..core.gfi import GenFn, NoChange, Extend, UnknownChange
from ..utils.spans import span
from .state import ParticleFilterState, effective_sample_size, log_ml_estimate
from .initialize import pf_initialize
from .update import pf_update
from .resample import pf_resample

__all__ = ["run_particle_filter", "tempered_smc"]


def _resample_rejuvenate(gen, state, resample_method, rejuvenate_fn, at,
                         span_prefix):
    with span(f"{span_prefix}.resample"):
        state = pf_resample(gen, state, resample_method, check=False)
    if rejuvenate_fn is not None:
        with span(f"{span_prefix}.rejuvenate"):
            state = rejuvenate_fn(gen, state, at)
    return state


def run_particle_filter(gen, model: GenFn, t_max: int, n_particles: int,
                        step_args_fn: Callable,
                        obs_fn: Callable,
                        ess_frac: float = 0.5,
                        resample_method: str = "systematic",
                        rejuvenate_fn: Callable | None = None,
                        argdiffs=None,
                        span_prefix: str = "smc",
                        mesh=None) -> ParticleFilterState:
    """Generic SSM particle filter, every random number drawn from
    ``gen``.

    - ``step_args_fn(t)``: model args for active length t+1
    - ``obs_fn(t)``: dense ChoiceMap constraining step t
    - ``rejuvenate_fn(gen, state, t)``: optional MCMC rejuvenation
    - ``argdiffs``: forwarded to pf_update; defaults to the incremental
      ``(Extend(1), NoChange...)`` promise.
    - ``mesh``: each rank initializes and carries ``n_particles /
      mesh.size`` of the particles, drawing from its own ``gen`` (seed it
      per rank); the global resample takes the first rank's draws.

    The JAX package's unused ``init_args`` parameter is left out.
    """
    n_local = n_particles if mesh is None else n_particles // mesh.size
    if mesh is not None and n_local * mesh.size != n_particles:
        raise ValueError(f"n_particles={n_particles} not divisible by the "
                         f"mesh's {mesh.size} ranks")
    with span(f"{span_prefix}.initialize"):
        state = pf_initialize(gen, model, step_args_fn(0), obs_fn(0),
                              n_local)
        if mesh is not None:
            state = state.replace(mesh=mesh)
    n_args = len(step_args_fn(0))
    diffs = argdiffs if argdiffs is not None else (
        (Extend(1),) + tuple(NoChange() for _ in range(n_args - 1)))
    for t in range(1, t_max):
        with span(f"{span_prefix}.ess_check"):
            low = bool(effective_sample_size(state) < ess_frac * n_particles)
        if low:
            state = _resample_rejuvenate(gen, state, resample_method,
                                         rejuvenate_fn, t, span_prefix)
        with span(f"{span_prefix}.update"):
            state = pf_update(gen, state, step_args_fn(t), diffs, obs_fn(t),
                              check=False)
    return state


def tempered_smc(gen, model: GenFn, betas, n_particles: int,
                 model_args_fn: Callable = None,
                 rejuvenate_fn: Callable | None = None,
                 ess_frac: float = 0.5,
                 resample_method: str = "systematic",
                 span_prefix: str = "smc"):
    """SMC across a model sequence parameterized by an inverse
    temperature.

    ``model`` takes args ``(beta,)`` (or ``model_args_fn(beta)``);
    particles start at ``betas[0]`` and move through each later model by an
    args-``update`` (weight = Δscore, the annealing incremental weight),
    with ESS-triggered resampling and optional rejuvenation
    ``rejuvenate_fn(gen, state, beta)``. An SMCP³ move replaces the
    args-update by ``pf_update(..., translator=UpdatingTraceTranslator(
    ...))``.

    Returns ``(state, log_ml_estimate)``.
    """
    args_of = model_args_fn or (lambda b: (b,))
    betas = torch.as_tensor(betas, dtype=torch.float32, device=gen.device)
    with span(f"{span_prefix}.initialize"):
        state = pf_initialize(gen, model, args_of(betas[0]), EMPTY,
                              n_particles)
    for i in range(1, betas.shape[0]):
        beta = betas[i]
        with span(f"{span_prefix}.ess_check"):
            low = bool(effective_sample_size(state) < ess_frac * n_particles)
        if low:
            state = _resample_rejuvenate(gen, state, resample_method,
                                         rejuvenate_fn, beta, span_prefix)
        args = args_of(beta)
        with span(f"{span_prefix}.update"):
            state = pf_update(gen, state, args,
                              tuple(UnknownChange() for _ in args), EMPTY,
                              check=False)
    return state, log_ml_estimate(state)
