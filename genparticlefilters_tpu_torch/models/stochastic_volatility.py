"""Nonlinear stochastic-volatility state-space model (BASELINE config 3:
move-reweight rejuvenation and ESS-triggered resampling, 100K
particles).

Model: h_t = μ + φ(h_{t−1} − μ) + σ·η,  y_t ~ N(0, exp(h_t/2));
h_0 ~ N(μ, σ/√(1−φ²)).

The filter runs init, then per step an ESS check, systematic resampling
plus one move-reweight rejuvenation of the latest volatility when ESS is
low, and a one-step ``Extend`` update; each phase in a ``sv.*``
``torch.profiler`` span.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import (gen, trace, normal, Unfold, ChoiceMap, Entry, Selection,
                    batched_interpretation)
from ..smc import pf_move_reweight, move_reweight
from ..smc.algorithms import run_particle_filter

__all__ = ["SVParams", "make_sv_model", "sv_obs_at_t", "sv_obs_dense",
           "sv_particle_filter", "synthesize_sv_data"]


class SVParams(NamedTuple):
    mu: float = -1.0
    phi: float = 0.95
    sigma: float = 0.3


def make_sv_model(t_max: int, p: SVParams) -> Unfold:
    """The model with static horizon ``t_max``. The step index ``t`` is a
    Python int, so step 0's prior is chosen on the host."""
    # the stationary scale in float32, as the JAX package computes it
    s0 = float(np.float32(p.sigma) / np.sqrt(np.float32(1.0 - p.phi ** 2)))

    @gen
    def sv_step(t, h):
        if t == 0:
            mean, scale = p.mu, s0
        else:
            mean, scale = p.mu + p.phi * (h - p.mu), p.sigma
        h = trace("h", normal(mean, scale))
        trace("y", normal(0.0, torch.exp(h / 2.0)))
        return h

    sv_step.batch_safe = True
    return Unfold(sv_step, t_max)


def sv_obs_at_t(y_obs_full, t):
    """Constrain only step ``t`` (a [T] mask)."""
    t_max = y_obs_full.shape[0]
    steps = torch.arange(t_max, device=y_obs_full.device)
    return ChoiceMap({("y",): Entry(y_obs_full, steps == t)})


def sv_obs_dense(y_obs_full):
    """Static-True observation mask: correct for Extend-driven filters and
    generate (every processed step observed); stores y SHARED (one [T] row
    instead of [T, N]) and skips its sampling pass."""
    return ChoiceMap({("y",): Entry(y_obs_full, True)})


def synthesize_sv_data(gen, t_max: int, p: SVParams):
    """Observations ``y [t_max]`` of one trajectory drawn from the model."""
    model = make_sv_model(t_max, p)
    h0 = torch.full((), p.mu, dtype=torch.float32, device=gen.device)
    with batched_interpretation(1):
        tr, _ = model.generate(gen, (t_max, h0), ChoiceMap())
    return tr.get_choices()[("y",)][:, 0]


def sv_particle_filter(gen, y_obs, n_particles: int, t_max: int,
                       p: SVParams, ess_frac: float = 0.5,
                       rejuv_steps: int = 1, rejuv_window: int | None = 2):
    """Filter with move-reweight rejuvenation of the most recent
    volatility. ``rejuv_window``: the promise that the rejuvenated
    selection only touches the last k active steps, so each move
    recomputes O(k) steps (the Unfold's full re-scan regenerate, which
    ``None`` would ask for, is not ported)."""
    device = gen.device
    y_obs = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    model = make_sv_model(t_max, p)
    h0 = torch.full((), p.mu, dtype=torch.float32, device=device)
    steps = torch.arange(t_max, device=device)
    obs = sv_obs_dense(y_obs)

    def rejuvenate(gen_, state, t):
        sel = Selection({("h",): steps == (t - 1)})
        return pf_move_reweight(gen_, state, move_reweight, (sel,),
                                n_iters=rejuv_steps, window=rejuv_window)

    return run_particle_filter(
        gen, model, t_max, n_particles,
        step_args_fn=lambda t: (t + 1, h0),
        obs_fn=lambda t: obs,
        ess_frac=ess_frac, resample_method="systematic",
        rejuvenate_fn=rejuvenate, span_prefix="sv")
