"""Object-motion switching SSM, the README example: an object is either
still or moving sinusoidally; the filter infers position ``y`` and the
``moving`` flag from noisy observations ``y_obs``.

The filter runs init, then per step an ESS check, resampling (residual
by default, as in the JAX package) plus windowed MH rejuvenation when ESS
is low, and a one-step ``Extend``
update. The ESS check is a Python ``if`` on a device scalar: one host
synchronisation per step.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..core import (gen, trace, bernoulli, normal, Unfold, ChoiceMap, Entry,
                    Selection, Extend, NoChange, batched_interpretation)
from ..smc import (pf_initialize, pf_update, pf_resample, pf_rejuvenate,
                   effective_sample_size, mh)
from ..utils.device import entry_device
from ..utils.spans import span as _span

__all__ = ["make_object_motion", "init_state", "synthesize_data",
           "obs_dense", "object_motion_filter", "exact_posterior"]


def make_object_motion(t_max: int, batch_safe: bool = True) -> Unfold:
    """The model with static horizon ``t_max``. With ``batch_safe=False``
    the step body is left unmarked, so every verb runs it per particle
    (``vmap_gfi``) rather than under one batched interpretation."""

    @gen
    def motion_step(t, state):
        y, moving = state
        moving = trace("moving", bernoulli(torch.where(moving, 0.75, 0.25)))
        tf = torch.full((), t, dtype=torch.float32, device=moving.device)
        vel = torch.where(moving, torch.sin(tf + 1.0), 0.0)
        y = trace("y", normal(y + vel, 0.01))
        trace("y_obs", normal(y, 0.25))
        return (y, moving)

    motion_step.batch_safe = batch_safe
    return Unfold(motion_step, t_max)


def init_state(device="cuda"):
    """The initial state ``(y = 0, moving = False)`` on ``device``: the card
    unless the caller asks for the CPU (``device="cpu"``); with no card,
    the default raises."""
    device = entry_device(device, "init_state")
    return (torch.zeros((), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def obs_dense(y_obs_full):
    """Dense observation constraint with a STATIC True mask: the handlers
    store the observed site SHARED (one [T] row, not [T, N]) and never
    sample it. Correct whenever every processed step is observed — the
    Extend-driven filter and ``generate``."""
    return ChoiceMap({("y_obs",): Entry(y_obs_full, True)})


def synthesize_data(gen, t_max: int, switch_t: int):
    """A ground-truth trajectory: still for ``switch_t`` steps, then
    moving. Returns (y_obs [t_max], trace of one particle)."""
    model = make_object_motion(t_max)
    device = gen.device
    moving = torch.arange(t_max, device=device) >= switch_t
    constraints = ChoiceMap({("moving",): Entry(moving, True)})
    with batched_interpretation(1):
        tr, _ = model.generate(gen, (t_max, init_state(device)), constraints)
    y_obs = tr.get_choices()[("y_obs",)][:, 0]
    return y_obs, tr


def object_motion_filter(gen, y_obs, n_particles: int, t_max: int,
                         ess_frac: float = 0.5,
                         resample_method: str = "residual", device=None,
                         batch_safe: bool = True):
    """The README particle filter: resampling + MH rejuvenation when
    ESS < ess_frac·N, then a one-step extension update. Runs on ``device``
    (default: the device of ``gen``), drawing every random number from
    ``gen``; ``batch_safe=False`` runs the step body per particle."""
    device = gen.device if device is None else torch.device(device)
    if device.type != gen.device.type:
        raise ValueError(f"generator on {gen.device}, filter on {device}")
    y_obs = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    model = make_object_motion(t_max, batch_safe)
    x0 = init_state(device)
    obs = obs_dense(y_obs)  # static-True mask: shared y_obs storage
    # the om.* spans name the filter's phases in a torch.profiler trace
    with _span("om.initialize"):
        state = pf_initialize(gen, model, (1, x0), obs, n_particles)
    steps = torch.arange(t_max, device=device)
    for t in range(1, t_max):
        with _span("om.ess_check"):
            low = bool(effective_sample_size(state) < ess_frac * n_particles)
        if low:
            with _span("om.resample"):
                state = pf_resample(gen, state, resample_method, check=False)
            with _span("om.rejuvenate"):
                sel_mask = (steps == t - 1) | (steps == t)
                sel = Selection({("moving",): sel_mask, ("y",): sel_mask})
                state = pf_rejuvenate(gen, state, mh, (sel,), window=2)
        with _span("om.update"):
            state = pf_update(gen, state, (t + 1, x0),
                              (Extend(1), NoChange()), obs, check=False)
    return state


def exact_posterior(y_obs):
    """Ground truth for a filter run: P(moving @ t) and the log marginal
    likelihood of ``y_obs`` (numpy float64), by enumerating all 2^T moving
    paths with a scalar Kalman filter per path (the model is linear-
    Gaussian given the path). Feasible up to T ≈ 14."""
    yo = np.asarray(y_obs, np.float64)
    T = len(yo)

    def log_joint(m):
        mu, var, lp, prev = 0.0, 0.0, 0.0, False
        for t in range(T):
            p = 0.75 if prev else 0.25
            lp += math.log(p) if m[t] else math.log(1 - p)
            prev = m[t]
            mu, var = mu + (math.sin(t + 1) if m[t] else 0.0), var + 0.01 ** 2
            S = var + 0.25 ** 2
            lp += -0.5 * (yo[t] - mu) ** 2 / S - 0.5 * math.log(
                2 * math.pi * S)
            K = var / S
            mu, var = mu + K * (yo[t] - mu), var * (1 - K)
        return lp

    paths = np.array(list(itertools.product([False, True], repeat=T)))
    lj = np.array([log_joint(m) for m in paths])
    w = np.exp(lj - lj.max())
    lml = float(np.log(w.sum()) + lj.max())
    return (w / w.sum()) @ paths, lml
