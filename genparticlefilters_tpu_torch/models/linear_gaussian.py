"""Linear-Gaussian SSM with exact Kalman-filter ground truth (BASELINE
config 2: the SMC posterior against the closed form, 10K particles,
systematic and stratified resampling).

Model: x_t = a·x_{t−1} + b + N(0, q²);  y_t ~ N(c·x_t, r²);  x_0 ~ N(m0, s0²).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import gen, trace, normal, Unfold, ChoiceMap, Entry
from ..core.gfi import batched_interpretation
from ..smc.algorithms import run_particle_filter

__all__ = ["LGParams", "make_lgssm", "lg_obs_at_t", "lg_obs_dense",
           "kalman_filter", "lgssm_particle_filter", "synthesize_lg_data"]


class LGParams(NamedTuple):
    a: float = 0.9
    b: float = 0.0
    q: float = 0.5
    c: float = 1.0
    r: float = 0.8
    m0: float = 0.0
    s0: float = 1.0


def make_lgssm(t_max: int, p: LGParams) -> Unfold:
    """The model with static horizon ``t_max``; the step index ``t`` is a
    Python int, so the t = 0 prior is a host branch."""

    @gen
    def lg_step(t, x):
        if t == 0:
            mean, scale = p.m0, p.s0
        else:
            mean, scale = p.a * x + p.b, p.q
        x = trace("x", normal(mean, scale))
        trace("y", normal(p.c * x, p.r))
        return x

    lg_step.batch_safe = True
    return Unfold(lg_step, t_max)


def lg_obs_at_t(y_obs_full, t):
    """Constrain only step ``t``: a one-hot ``[T]`` mask, built on the
    device of ``y_obs_full``."""
    steps = torch.arange(y_obs_full.shape[0], device=y_obs_full.device)
    return ChoiceMap({("y",): Entry(y_obs_full, steps == t)})


def lg_obs_dense(y_obs_full):
    """Dense observation constraint with a static True mask: the handlers
    store ``y`` shared across particles (one ``[T]`` row)."""
    return ChoiceMap({("y",): Entry(y_obs_full, True)})


def synthesize_lg_data(gen, t_max: int, p: LGParams):
    """Observations ``y [t_max]`` of one trajectory simulated from
    ``gen``."""
    model = make_lgssm(t_max, p)
    x0 = torch.zeros((), dtype=torch.float32, device=gen.device)
    with batched_interpretation(1):
        tr, _ = model.generate(gen, (t_max, x0))
    return tr.get_choices()[("y",)][:, 0]


def kalman_filter(y_obs, p: LGParams):
    """Exact filtering posterior N(mu_t, var_t) per step and the total
    log marginal likelihood, in numpy float64."""
    mus, vars_, lml = [], [], 0.0
    mu, var = 0.0, 1.0
    for t, y in enumerate(np.asarray(y_obs, np.float64)):
        pm = p.m0 if t == 0 else p.a * mu + p.b
        pv = p.s0 ** 2 if t == 0 else p.a ** 2 * var + p.q ** 2
        S = p.c ** 2 * pv + p.r ** 2
        lml += -0.5 * (y - p.c * pm) ** 2 / S - 0.5 * np.log(2.0 * np.pi * S)
        K = pv * p.c / S
        mu = pm + K * (y - p.c * pm)
        var = (1.0 - K * p.c) * pv
        mus.append(mu)
        vars_.append(var)
    return np.array(mus), np.array(vars_), float(lml)


def lgssm_particle_filter(gen, y_obs, n_particles: int, t_max: int,
                          p: LGParams, resample_method: str = "systematic",
                          ess_frac: float = 0.5):
    """The config-2 filter: ESS-triggered resampling, no rejuvenation,
    every random number drawn from ``gen`` (on its device)."""
    device = gen.device
    y_obs = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    model = make_lgssm(t_max, p)
    x0 = torch.zeros((), dtype=torch.float32, device=device)
    obs = lg_obs_dense(y_obs)
    return run_particle_filter(
        gen, model, t_max, n_particles,
        step_args_fn=lambda t: (t + 1, x0),
        obs_fn=lambda t: obs,
        ess_frac=ess_frac, resample_method=resample_method)
