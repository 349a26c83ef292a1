"""Multi-object tracking SSM (BASELINE config 5: 1M particles with online
particle resizing).

K objects move as independent 2-D random walks with process noise ``q``;
each is observed with Gaussian noise ``r``. The latent site is one
``[K, 2]`` array choice per step, so a step's propagate and reweight are a
few elementwise kernels over ``[N, K, 2]``. The packed step storage holds
``16`` rows per step at K=4 (the ``x`` site and the ``[K, 2]`` carry it
returns, which is too wide for the scalar carry cache), so the trace packs
``16·T + 1`` rows: 161 at T=10 and 1025 at T=64.

The config-5 filter (``mot_particle_filter``) is ``run_particle_filter``
under span prefix ``mot``: systematic resampling when the ESS falls below
``ess_frac`` times the current count, one-step ``Extend`` updates, and,
given a ``resize_schedule``, online resizing. Config 5's schedule
(:func:`mot_resize_schedule`, after ``scripts/config45_bench.py``) resizes
residually to N/2 before step T//3 and multinomially back to N before step
2T//3: at T=10 and N=1M, 1M -> 500K before step 3 and 500K -> 1M before
step 6. Its phases are the ``mot.initialize``, ``mot.resize``,
``mot.ess_check``, ``mot.resample`` and ``mot.update`` spans.
``mot_particle_filter_captured`` captures the whole filter as one CUDA
graph (9 IF nodes at T=10, the two resizes between them) and replays it
with new observations.

The data-association variant adds a ``[K]`` int32 ``assoc`` site per step:
observation slot j is produced by object ``assoc[j]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gen, trace, normal, uniform_discrete, Unfold, ChoiceMap, \
    Entry, batched_interpretation
from ..smc.algorithms import run_particle_filter
from ..smc.capture import capture
from ..utils.device import entry_device

__all__ = ["MOTParams", "make_mot_model", "mot_obs_at_t", "mot_obs_dense",
           "synthesize_mot_data", "mot_resize_schedule",
           "mot_particle_filter", "mot_particle_filter_captured",
           "make_mot_da_model", "synthesize_mot_da_data",
           "mot_da_particle_filter"]


class MOTParams(NamedTuple):
    n_objects: int = 4
    q: float = 0.3   # process noise
    r: float = 0.5   # observation noise
    s0: float = 2.0  # initial spread


def _x0(p: MOTParams, device="cuda"):
    """The ``[K, 2]`` initial state on ``device``: the card unless the
    caller asks for the CPU; with no card, the default raises."""
    return torch.zeros((p.n_objects, 2), dtype=torch.float32,
                       device=entry_device(device, "_x0"))


def make_mot_model(t_max: int, p: MOTParams) -> Unfold:
    """The MOT model with static horizon ``t_max``; args ``(t, x0)``."""

    @gen
    def mot_step(t, x):
        mean = torch.zeros_like(x) if t == 0 else x
        scale = p.s0 if t == 0 else p.q
        x = trace("x", normal(mean, scale))          # [K, 2] vector site
        trace("y", normal(x, p.r))                   # [K, 2] observations
        return x

    mot_step.batch_safe = True
    return Unfold(mot_step, t_max)


def mot_obs_at_t(y_obs_full, t):
    """y_obs_full: ``[T, K, 2]``; constrain exactly step t."""
    y = torch.as_tensor(y_obs_full)
    t_max = y.shape[0]
    return ChoiceMap({("y",): Entry(y, torch.arange(t_max,
                                                    device=y.device) == t)})


def mot_obs_dense(y_obs_full):
    """Static-True observation mask: ``y`` is stored SHARED, one
    ``[T, K, 2]`` array instead of ``[T, N, K, 2]`` rows (320 MB at
    N=1M), and leaves every resampling gather."""
    return ChoiceMap({("y",): Entry(torch.as_tensor(y_obs_full), True)})


def _simulate_one(gen_, model, t_max, p):
    """One trajectory of ``model``: its choices, particle axis dropped."""
    with batched_interpretation(1):
        tr, _ = model.generate(gen_, (t_max, _x0(p, gen_.device)))
    ch = tr.get_choices()
    return {k: e.value[:, 0] for k, e in ch.entries.items()}


def synthesize_mot_data(gen_, t_max: int, p: MOTParams):
    """Observations ``y [T, K, 2]`` of one simulated trajectory."""
    return _simulate_one(gen_, make_mot_model(t_max, p), t_max, p)[("y",)]


def mot_resize_schedule(n_particles: int, t_max: int) -> dict:
    """Config 5's online resizing: a residual resize to N/2 before step
    T//3 and a multinomial resize back to N before step 2T//3."""
    return {t_max // 3: (n_particles // 2, "residual"),
            2 * t_max // 3: (n_particles, "multinomial")}


def mot_particle_filter(gen_, y_obs, n_particles: int, t_max: int,
                        p: MOTParams, ess_frac: float = 0.5,
                        resample_method: str = "systematic",
                        resize_schedule=None):
    """The config-5 filter: ESS-triggered resampling (below ``ess_frac``
    times the current count) and one-step extensions over the dense
    observations, every draw from ``gen_``, in ``mot.*`` spans. With
    ``resize_schedule`` (``{t: (n_new, method)}``, e.g.
    :func:`mot_resize_schedule`) the particle set is resized before step
    t's check; without it the count stays ``n_particles``."""
    model = make_mot_model(t_max, p)
    x0 = _x0(p, gen_.device)
    obs = mot_obs_dense(torch.as_tensor(y_obs, device=gen_.device))
    return run_particle_filter(
        gen_, model, t_max, n_particles,
        step_args_fn=lambda t: (t + 1, x0), obs_fn=lambda t: obs,
        ess_frac=ess_frac, resample_method=resample_method,
        span_prefix="mot", resize_schedule=resize_schedule)


def mot_particle_filter_captured(gen_, y_obs, n_particles: int, t_max: int,
                                 p: MOTParams, ess_frac: float = 0.5,
                                 resample_method: str = "systematic",
                                 resize_schedule=None):
    """:func:`mot_particle_filter` captured once as a CUDA graph on
    ``gen_``'s card. Returns a :class:`~..smc.capture.CapturedRun`:
    ``run(y)`` replays it with new observations ``y [T, K, 2]``, drawing
    from ``gen_`` at its current state, and returns a fresh state."""
    return capture(mot_particle_filter, gen_, y_obs, n_particles, t_max, p,
                   ess_frac=ess_frac, resample_method=resample_method,
                   resize_schedule=resize_schedule)


# ---------------------------------------------------------------------------
# Unknown data association: each observation slot carries a categorical
# latent naming the object that produced it.
# ---------------------------------------------------------------------------

def _take_objects(x, assoc):
    """``x[..., assoc[j], :]`` per slot j, batch-polymorphic: ``x`` may be
    ``[N, K, 2]`` or shared ``[K, 2]``, ``assoc`` ``[N, K]`` or ``[K]``
    (``x[assoc]`` would gather particles)."""
    xb, ab = torch.broadcast_tensors(x, assoc[..., None].to(torch.int64))
    return torch.gather(xb, -2, ab)


def make_mot_da_model(t_max: int, p: MOTParams, anchors=None) -> Unfold:
    """MOT with per-slot association latents: slot j's observation is
    produced by object ``assoc[j]`` (uniform prior over objects).

    ``anchors [K, 2]`` give the objects distinct initial-position priors;
    without them object labels are exchangeable and associations are only
    identified up to relabeling."""
    k = p.n_objects
    anchors = (torch.zeros((k, 2), dtype=torch.float32) if anchors is None
               else torch.as_tensor(anchors, dtype=torch.float32))

    @gen
    def mot_da_step(t, x):
        mean = anchors.to(x.device) if t == 0 else x
        scale = p.s0 if t == 0 else p.q
        x = trace("x", normal(mean, scale))              # [K, 2]
        assoc = trace("assoc", uniform_discrete(
            torch.zeros((k,), dtype=torch.int32, device=x.device), k - 1))
        trace("y", normal(_take_objects(x, assoc), p.r))  # [K, 2]
        return x

    mot_da_step.batch_safe = True
    return Unfold(mot_da_step, t_max)


def synthesize_mot_da_data(gen_, t_max: int, p: MOTParams, anchors=None):
    """``(y [T, K, 2], assoc [T, K])`` of one simulated trajectory."""
    ch = _simulate_one(gen_, make_mot_da_model(t_max, p, anchors), t_max, p)
    return ch[("y",)], ch[("assoc",)]


def mot_da_particle_filter(gen_, y_obs, n_particles: int, t_max: int,
                           p: MOTParams, ess_frac: float = 0.5,
                           anchors=None):
    """The data-association filter (systematic resampling)."""
    model = make_mot_da_model(t_max, p, anchors)
    x0 = _x0(p, gen_.device)
    obs = mot_obs_dense(torch.as_tensor(y_obs, device=gen_.device))
    return run_particle_filter(
        gen_, model, t_max, n_particles,
        step_args_fn=lambda t: (t + 1, x0), obs_fn=lambda t: obs,
        ess_frac=ess_frac, resample_method="systematic")
