"""Canned SMC drivers: the README loop as reusable functions.

- :func:`run_particle_filter`: a state-space particle filter with
  ESS-triggered resampling (and optional rejuvenation), optionally
  resizing the particle set online on a schedule;
- :func:`tempered_smc`: SMC over a model *sequence* (annealing), each
  move an ``update`` to new model arguments, with ESS-triggered
  resampling and optional rejuvenation.

Both are Python loops over the steps, with the ESS trigger a
:func:`~.capture.device_cond`: eager, one host read of the device scalar
per step; under :func:`~.capture.capture`, an IF node inside the CUDA
graph whose branch runs only where the predicate holds (the loop
unrolls, as ``lax.scan`` is lowered) and no host read. The loop rebinds
``state`` to the branch's result and keeps no other reference to it, so
each call donates it (``donate=True``): a taken branch writes its result
back into the state's own tensors and an untaken one does nothing, and
the update writes the new step into the state's trace store in place.
Given a particle ``mesh`` (parallel/mesh.py),
:func:`run_particle_filter` runs each rank's block of the particles: the
ESS is global, so every rank takes the same branch, and the resample is
the exact global one. Each phase runs in a ``torch.profiler`` span:
``{span_prefix}.initialize``, ``.resize``, ``.ess_check``, ``.resample``,
``.rejuvenate`` and ``.update``; each model's wrapper passes its own
prefix (``om``, ``sv``, ``tm``, ``mot``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.choicemap import EMPTY
from ..core.gfi import GenFn, NoChange, Extend, UnknownChange
from ..ops.ess_check import ess_below
from ..utils.spans import span
from .state import (ParticleFilterState, _mesh, effective_sample_size,
                    log_ml_estimate, num_particles)
from .initialize import pf_initialize
from .update import pf_update
from .resample import pf_resample
from .resize import pf_resize
from .capture import device_cond, host_pred

__all__ = ["run_particle_filter", "tempered_smc"]


def _ess_low(state, ess_frac: float, span_prefix: str):
    """The ESS check, in a ``{span_prefix}.ess_check`` span: ESS below
    ``ess_frac`` times the count the state holds (:func:`host_pred`). An
    unsharded state's check is :func:`~..ops.ess_check.ess_below` (one
    kernel on the card, its plain version on the CPU); a sharded state's
    ESS is the global one."""
    with span(f"{span_prefix}.ess_check"):
        threshold = ess_frac * num_particles(state)
        if _mesh(state) is None:
            low = ess_below(state.log_weights, threshold)
        else:
            low = effective_sample_size(state) < threshold
        return host_pred(low)


def _resample_rejuvenate(gen, state, resample_method, rejuvenate_fn, at,
                         span_prefix):
    with span(f"{span_prefix}.resample"):
        state = pf_resample(gen, state, resample_method, check=False)
    if rejuvenate_fn is not None:
        with span(f"{span_prefix}.rejuvenate"):
            state = rejuvenate_fn(gen, state, at)
    return state


def _check_schedule(schedule, t_max: int, mesh) -> dict:
    """``schedule`` as ``{t: (n_new, method)}``, after checking that each
    step lies in 1..t_max-1 and each count is positive; ``{}`` for
    none."""
    if not schedule:
        return {}
    if mesh is not None:
        raise NotImplementedError(
            "run_particle_filter(resize_schedule=..., mesh=...): online "
            "resizing of a sharded state is not built (pf_resize resizes "
            "one block)")
    out = {}
    for t, (n_new, method) in schedule.items():
        if not 1 <= int(t) < t_max or int(n_new) < 1:
            raise ValueError(f"resize_schedule: step {t} must lie in 1.."
                             f"{t_max - 1} and the count {n_new} be positive")
        out[int(t)] = (int(n_new), method)
    return out


def run_particle_filter(gen, model: GenFn, t_max: int, n_particles: int,
                        step_args_fn: Callable,
                        obs_fn: Callable,
                        ess_frac: float = 0.5,
                        resample_method: str = "systematic",
                        rejuvenate_fn: Callable | None = None,
                        argdiffs=None,
                        span_prefix: str = "smc",
                        mesh=None,
                        resize_schedule=None) -> ParticleFilterState:
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
    - ``resize_schedule``: ``{t: (n_new, method)}``, online resizing:
      before step t's ESS check the state is resized to ``n_new``
      particles by ``pf_resize(gen, state, n_new, method, check=False)``
      (``multinomial``, ``residual`` or ``optimal``), in a
      ``{span_prefix}.resize`` span. The resize draws from ``gen`` before
      the check does. Every ESS check compares with ``ess_frac`` times
      the count the state then holds (on a mesh, the global count).

    The JAX package's unused ``init_args`` parameter is left out.
    """
    n_local = n_particles if mesh is None else n_particles // mesh.size
    if mesh is not None and n_local * mesh.size != n_particles:
        raise ValueError(f"n_particles={n_particles} not divisible by the "
                         f"mesh's {mesh.size} ranks")
    schedule = _check_schedule(resize_schedule, t_max, mesh)
    with span(f"{span_prefix}.initialize"):
        state = pf_initialize(gen, model, step_args_fn(0), obs_fn(0),
                              n_local)
        if mesh is not None:
            state = state.replace(mesh=mesh)
    n_args = len(step_args_fn(0))
    diffs = argdiffs if argdiffs is not None else (
        (Extend(1),) + tuple(NoChange() for _ in range(n_args - 1)))
    for t in range(1, t_max):
        if t in schedule:
            n_new, method = schedule[t]
            with span(f"{span_prefix}.resize"):
                state = pf_resize(gen, state, n_new, method, check=False)
        low = _ess_low(state, ess_frac, span_prefix)
        state = device_cond(low, lambda s: _resample_rejuvenate(
            gen, s, resample_method, rejuvenate_fn, t, span_prefix), state,
            donate=True)
        with span(f"{span_prefix}.update"):
            state = pf_update(gen, state, step_args_fn(t), diffs, obs_fn(t),
                              check=False, donate=True)
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

    Returns ``(state, log_ml_estimate)``. ``betas`` is read where it
    lies: under :func:`~.capture.capture`, pass a tensor on the card (a
    static input buffer), not a host list.
    """
    args_of = model_args_fn or (lambda b: (b,))
    betas = torch.as_tensor(betas, dtype=torch.float32, device=gen.device)
    with span(f"{span_prefix}.initialize"):
        state = pf_initialize(gen, model, args_of(betas[0]), EMPTY,
                              n_particles)
    for i in range(1, betas.shape[0]):
        beta = betas[i]
        low = _ess_low(state, ess_frac, span_prefix)
        state = device_cond(low, lambda s: _resample_rejuvenate(
            gen, s, resample_method, rejuvenate_fn, beta, span_prefix), state,
            donate=True)
        args = args_of(beta)
        with span(f"{span_prefix}.update"):
            state = pf_update(gen, state, args,
                              tuple(UnknownChange() for _ in args), EMPTY,
                              check=False, donate=True)
    return state, log_ml_estimate(state)
