"""Plain reference for the object-motion cells (the README switching SSM).

Model, with ``p`` the configuration's numbers: ``moving_t ~
Bernoulli(p_stay_moving if moving_{t-1} else p_start_moving)``,
``y_t ~ N(y_{t-1} + sin(t + 1)·moving_t, y_sd)``, ``y_obs_t ~ N(y_t,
obs_sd)``, from ``moving_{-1} = False``, ``y_{-1} = 0``.

- :func:`exact`: P(moving_t | y_obs) and the log marginal likelihood by
  enumerating all 2^T moving paths, a scalar Kalman filter per path (the
  model is linear-Gaussian given the path), in float64;
- :func:`judge`: the numbers ``correct`` compares, for one filter answer;
- :func:`reference_filter`: the README filter written plainly (bootstrap
  proposals, resampling when the ESS falls below ``ess_frac·N``, one MH
  move of the newest step drawn from its prior) in a given dtype; in
  bfloat16 it is the control.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .common import (lnorm, suffix_sums, is_identity, parents_bad,
                     sibling_pairs, first_diff, ess_violations, relative_gap,
                     move_deficit, weighted_mean, systematic, residual)

LATENTS = ("moving", "y")


def exact(y_obs, p):
    """(P(moving_t | y_obs) [T], log p(y_obs)), float64 numpy."""
    yo = np.asarray(y_obs, np.float64)
    t_max = yo.shape[0]
    paths = np.array(list(itertools.product([False, True], repeat=t_max)))
    k = paths.shape[0]
    lp = np.zeros(k)
    mu, var = np.zeros(k), np.zeros(k)
    prev = np.zeros(k, bool)
    for t in range(t_max):
        m = paths[:, t]
        q = np.where(prev, p["p_stay_moving"], p["p_start_moving"])
        lp += np.where(m, np.log(q), np.log1p(-q))
        prev = m
        mu = mu + np.where(m, math.sin(t + 1.0), 0.0)
        var = var + p["y_sd"] ** 2
        s = var + p["obs_sd"] ** 2
        lp += -0.5 * (yo[t] - mu) ** 2 / s - 0.5 * np.log(2 * math.pi * s)
        gain = var / s
        mu, var = mu + gain * (yo[t] - mu), var * (1 - gain)
    top = lp.max()
    w = np.exp(lp - top)
    return (w / w.sum()) @ paths, float(np.log(w.sum()) + top)


def exact_lml(y_obs, p) -> float:
    """log p(y_obs), float64, by :func:`exact`."""
    return exact(torch.as_tensor(y_obs).double().cpu().numpy(), p)[1]


def _step_loglik(moving, y, p):
    """log p(moving_t, y_t | step t-1) for every step, float64 [T, N]."""
    t_max, n = y.shape
    prev_m = torch.zeros(n, dtype=torch.bool, device=y.device)
    prev_y = torch.zeros(n, dtype=torch.float64, device=y.device)
    out = []
    for t in range(t_max):
        q = p["p_start_moving"] + prev_m.double() * (
            p["p_stay_moving"] - p["p_start_moving"])
        lm = torch.where(moving[t], torch.log(q), torch.log1p(-q))
        vel = moving[t].double() * math.sin(t + 1.0)
        out.append(lm + lnorm(y[t], prev_y + vel, p["y_sd"]))
        prev_m, prev_y = moving[t], y[t]
    return torch.stack(out)


def judge(ans, y_obs, p, ess_frac: float) -> dict:
    """The numbers of one answer (see ``PERF.md`` for each):

    - ``score_gap``: largest |trace score − the joint log density of the
      particle's latents and the observations|, over 1 + the sum of the
      absolute values of the density's terms (a relative gap: float32
      rounding reads about 1e-7 on any particle);
    - ``weight_gap``: largest |log weight − Σ_{t ≥ t0} log p(y_obs_t |
      y_t)|, relative as above, t0 the last resampling step (0 with
      identity parents): what the filter's weights must be after
      resampling at t0, MH (which keeps weights) and Extend updates;
    - ``sibling_mismatch``: pairs of particles of one parent whose latents
      differ before step t0 − 1 (MH moves only step t0 − 1);
    - ``move_deficit``: −ln of the share (+1 over pairs + 1) of those
      pairs that differ at step t0 − 1, where only the MH move can part
      them (t0 is read from the weights, which MH leaves as they are): a
      filter that skips its MH reads ln(pairs + 1);
    - ``ess_violations``: checks after t0 at which the ESS of the weights
      then held was below the threshold, so the filter had to resample;
    - ``parents_bad``: parents outside [0, N);
    - ``lml_gap``: |LML estimate − the exact log marginal likelihood|;
    - ``posterior_gap``: largest |weighted P(moving_t) − exact|."""
    dev = ans["log_weights"].device
    moving = ans["latents"]["moving"].to(torch.bool)
    y = ans["latents"]["y"].double()
    yo = torch.as_tensor(y_obs, device=dev).double()
    t_max = y.shape[0]
    ll = lnorm(y, yo[:, None], p["obs_sd"])
    steps = _step_loglik(moving, y, p)
    score = steps.sum(0) + ll.sum(0)
    scale = steps.abs().sum(0) + ll.abs().sum(0)
    lw = ans["log_weights"].double()
    cum, size = suffix_sums(ll), suffix_sums(ll.abs())
    parents = ans["parents"]
    if is_identity(parents):
        t0, mismatch, deficit = 0, 0, 0.0
        weight_gap = relative_gap(lw, cum[0], size[0])
    else:
        gaps = [relative_gap(lw, cum[t], size[t]) for t in range(1, t_max)]
        t0 = 1 + int(np.argmin(gaps))
        weight_gap = gaps[t0 - 1]
        a, b = sibling_pairs(parents)
        fd = first_diff([moving, y], a, b)
        mismatch = int((fd < t0 - 1).sum())
        deficit = move_deficit(int((fd == t0 - 1).sum()), a.shape[0])
    post, lml = exact(yo.cpu().numpy(), p)
    est = [weighted_mean(lw, moving[t].double()) for t in range(t_max)]
    return {
        "score_gap": relative_gap(ans["score"].double(), score, scale),
        "weight_gap": weight_gap,
        "sibling_mismatch": mismatch,
        "move_deficit": deficit,
        "ess_violations": ess_violations(lw, cum, t0, ess_frac),
        "parents_bad": parents_bad(parents),
        "lml_gap": abs(float(ans["lml"]) - lml),
        "posterior_gap": float(np.max(np.abs(np.array(est) - post))),
    }


def reference_filter(gen, y_obs, n: int, p, ess_frac: float, method: str,
                     dtype=torch.float32) -> dict:
    """The README filter in plain PyTorch, every value and every step of
    arithmetic in ``dtype`` (a float32 filter's resampling sums in
    float64, see ``common``), drawing from ``gen`` on ``y_obs``'s device.
    Returns an answer as :func:`judge` takes it."""
    dev = y_obs.device
    yo = y_obs.to(dtype)
    t_max = yo.shape[0]
    resample = {"systematic": systematic, "residual": residual}[method]
    moving = torch.zeros((t_max, n), dtype=torch.bool, device=dev)
    y = torch.zeros((t_max, n), dtype=dtype, device=dev)
    no_m = torch.zeros(n, dtype=torch.bool, device=dev)
    no_y = torch.zeros(n, dtype=dtype, device=dev)

    def draw(t, prev_m, prev_y):
        q = torch.where(prev_m, p["p_stay_moving"], p["p_start_moving"]
                        ).to(dtype)
        m = torch.rand(n, generator=gen, device=dev).to(dtype) < q
        vel = torch.where(m, math.sin(t + 1.0), 0.0).to(dtype)
        eps = torch.randn(n, generator=gen, device=dev).to(dtype)
        return m, prev_y + vel + p["y_sd"] * eps

    def prev(t):
        return (moving[t - 1], y[t - 1]) if t > 0 else (no_m, no_y)

    log_n = torch.tensor(math.log(n), dtype=dtype, device=dev)
    moving[0], y[0] = draw(0, no_m, no_y)
    lw = lnorm(y[0], yo[0], p["obs_sd"])
    lml = torch.zeros((), dtype=dtype, device=dev)
    parents = torch.arange(n, device=dev)
    for t in range(1, t_max):
        w = torch.softmax(lw, 0)
        if float(1.0 / torch.sum(w * w)) < ess_frac * n:
            lml = lml + torch.logsumexp(lw, 0) - log_n
            parents = resample(gen, w)
            moving[:t] = moving[:t, parents]
            y[:t] = y[:t, parents]
            lw = torch.zeros(n, dtype=dtype, device=dev)
            m_new, y_new = draw(t - 1, *prev(t - 1))
            ratio = (lnorm(y_new, yo[t - 1], p["obs_sd"])
                     - lnorm(y[t - 1], yo[t - 1], p["obs_sd"]))
            u = torch.rand(n, generator=gen, device=dev).to(dtype)
            acc = torch.log(u) < ratio
            moving[t - 1] = torch.where(acc, m_new, moving[t - 1])
            y[t - 1] = torch.where(acc, y_new, y[t - 1])
        moving[t], y[t] = draw(t, *prev(t))
        lw = lw + lnorm(y[t], yo[t], p["obs_sd"])
    score = torch.zeros(n, dtype=dtype, device=dev)
    for t in range(t_max):
        pm, py = prev(t)
        q = torch.where(pm, p["p_stay_moving"], p["p_start_moving"]
                        ).to(dtype)
        vel = torch.where(moving[t], math.sin(t + 1.0), 0.0).to(dtype)
        score = (score + torch.where(moving[t], torch.log(q),
                                     torch.log1p(-q))
                 + lnorm(y[t], py + vel, p["y_sd"])
                 + lnorm(y[t], yo[t], p["obs_sd"]))
    return {"latents": {"moving": moving, "y": y}, "log_weights": lw,
            "lml": lml + torch.logsumexp(lw, 0) - log_n,
            "parents": parents, "score": score}
