"""Tempered SMC over a model sequence (BASELINE config 4).

A static latent with a bimodal likelihood, annealed from the prior (β=0)
to the posterior (β=1) through the inverse-temperature schedule
``linspace(0, 1, n_temps)²``. The model-sequence move is an
args-``update`` whose incremental weight is exactly Δβ·loglik through a
:class:`~..core.distributions.Factor` site; SMCP³ auxiliary-variable moves
compose through ``pf_update(translator=...)``. Each phase runs in a
``tm.*`` ``torch.profiler`` span.

Ground truth: the normalizing constant Z(β=1) = ∫ prior·lik dx by
quadrature, so the SMC LML estimate is exactly checkable.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import gen, trace, normal, factor, select
from ..smc import pf_rejuvenate, mh
from ..smc.algorithms import tempered_smc

__all__ = ["make_tempered_model", "tempered_loglik", "run_tempered_smc",
           "tempered_log_z", "PRIOR_LOC", "PRIOR_SCALE", "MODES",
           "MODE_SCALE"]

PRIOR_LOC, PRIOR_SCALE = 0.0, 3.0
MODES = (-2.0, 2.5)
MODE_SCALE = 0.35


def tempered_loglik(x):
    """Bimodal likelihood: an equal mixture of two narrow Gaussians."""
    log_norm = torch.log(torch.full((), MODE_SCALE * math.sqrt(2.0 * math.pi),
                                    dtype=torch.float32, device=x.device))
    comps = torch.stack([-0.5 * ((x - m) / MODE_SCALE) ** 2 - log_norm
                         for m in MODES])
    return torch.logsumexp(comps, 0) - math.log(float(len(MODES)))


def make_tempered_model():
    @gen
    def model(beta):
        x = trace("x", normal(PRIOR_LOC, PRIOR_SCALE))
        trace("lik", factor(beta * tempered_loglik(x)))
        return x

    model.batch_safe = True
    return model


def tempered_log_z(n_grid: int = 20001, lo=-15.0, hi=15.0):
    """Quadrature ground truth for log Z(β=1), in float64 (numpy)."""
    xs = np.linspace(lo, hi, n_grid)
    comps = np.stack([-0.5 * ((xs - m) / MODE_SCALE) ** 2
                      - math.log(MODE_SCALE * math.sqrt(2.0 * math.pi))
                      for m in MODES])
    cm = comps.max(0)
    loglik = cm + np.log(np.exp(comps - cm).sum(0)) - math.log(len(MODES))
    lp = (-0.5 * ((xs - PRIOR_LOC) / PRIOR_SCALE) ** 2
          - math.log(PRIOR_SCALE * math.sqrt(2.0 * math.pi)) + loglik)
    dx = (hi - lo) / (n_grid - 1)
    m = lp.max()
    return float(m + math.log(np.exp(lp - m).sum()) + math.log(dx))


def run_tempered_smc(gen, n_particles: int, n_temps: int = 50,
                     rejuv_iters: int = 2, ess_frac: float = 0.75):
    """Tempered SMC at ``n_particles`` over ``n_temps`` temperatures, with
    ``rejuv_iters`` MH sweeps on x after each resampling (when ESS <
    ``ess_frac``·N; the JAX package's driver fixes it at 0.75). Returns
    ``(state, log_ml_estimate)``."""
    model = make_tempered_model()
    betas = torch.linspace(0.0, 1.0, n_temps, dtype=torch.float32,
                           device=gen.device) ** 2

    def rejuvenate(gen_, state, beta):
        return pf_rejuvenate(gen_, state, mh, (select("x"),),
                             n_iters=rejuv_iters)

    return tempered_smc(gen, model, betas, n_particles,
                        rejuvenate_fn=rejuvenate, ess_frac=ess_frac,
                        span_prefix="tm")
