"""Plain reference for the stochastic-volatility cells (Kim, Shephard and
Chib 1998).

Model, with ``p`` the configuration's numbers: ``h_0 ~ N(mu, s0)``,
``s0 = sigma / sqrt(1 − phi²)``, ``h_t ~ N(mu + phi·(h_{t-1} − mu),
sigma)``, ``y_t ~ N(0, exp(h_t / 2))``.

- :func:`grid`: the filtering law on a fine grid of h (the state is one
  number), in float64: the log marginal likelihood and E[h_{T-1} | y],
  exact to far below the particle filter's Monte Carlo error;
- :func:`judge`: the numbers ``correct`` compares, for one filter answer;
- :func:`reference_filter`: the filter written plainly (bootstrap
  proposals, systematic resampling when the ESS falls below
  ``ess_frac·N``, one move-reweight of the newest h drawn from its prior)
  in a given dtype; in bfloat16 it is the control.
"""

from __future__ import annotations

import math

import torch

from .common import (lnorm, suffix_sums, is_identity, parents_bad,
                     sibling_pairs, first_diff, group_spread, ess_violations,
                     relative_gap, move_deficit, weighted_mean, systematic)

LATENTS = ("h",)

#: a move-reweight's term below this share of 1 + the weight's relative
#: scale reads as no term: 30 times the float32 rounding that sound runs
#: show within one parent's group (``weight_gap``, about 3e-5)
MOVED_TOL = 1e-3

#: grid points and half-width (in stationary sd) of :func:`grid`
GRID_POINTS = 2048
GRID_WIDTH = 10.0


def stationary_sd(p) -> float:
    return p["sigma"] / math.sqrt(1.0 - p["phi"] ** 2)


def grid(y_obs, p, points: int = GRID_POINTS):
    """(log p(y), E[h_{T-1} | y]) by the grid filter, float64, on
    ``y_obs``'s device."""
    dev = y_obs.device
    y = y_obs.double()
    s0 = stationary_sd(p)
    h = torch.linspace(p["mu"] - GRID_WIDTH * s0, p["mu"] + GRID_WIDTH * s0,
                       points, dtype=torch.float64, device=dev)
    dh = float(h[1] - h[0])
    trans = torch.exp(lnorm(h[None, :], p["mu"] + p["phi"] * (h[:, None]
                                                             - p["mu"]),
                            p["sigma"])) * dh
    dens = torch.exp(lnorm(h, p["mu"], s0)) * dh
    lml = 0.0
    for t in range(y.shape[0]):
        if t:
            dens = dens @ trans
        dens = dens * torch.exp(lnorm(y[t], 0.0, torch.exp(h / 2.0)))
        mass = dens.sum()
        lml += float(torch.log(mass))
        dens = dens / mass
    return lml, float((dens * h).sum())


def exact_lml(y_obs, p) -> float:
    """log p(y_obs), float64, by :func:`grid`."""
    return grid(torch.as_tensor(y_obs), p)[0]


def judge(ans, y_obs, p, ess_frac: float) -> dict:
    """The numbers of one answer (see ``PERF.md``):

    - ``score_gap``: largest |trace score − the joint log density of the
      particle's h and the observations|, over 1 + the sum of the
      absolute values of the density's terms (a relative gap);
    - ``weight_gap``: t0 the last resampling step, found as one past the
      step at which most pairs of particles of one parent first differ
      (the move-reweight after resampling moves step t0 − 1 of every
      particle): the largest spread, within one parent's particles, of
      log weight − Σ_{t ≥ t0−1} log p(y_t | h_t), which must be one
      number per parent (minus log p(y_{t0−1} | the parent's old h)),
      relative as above; with identity parents, |log weight − Σ_t
      log p(y_t | h_t)|, relative;
    - ``sibling_mismatch``: pairs of one parent that differ before t0 − 1
      (where they must share the parent's history);
    - ``move_deficit``: −ln of the share (+1 over N + 1) of particles
      whose log weight carries the move-reweight's term, i.e. whose
      log weight − Σ_{t ≥ t0−1} log p(y_t | h_t) (minus log p(y_{t0−1} |
      the parent's old h)) is not 0 to within :data:`MOVED_TOL` of the
      relative scale. A filter that skips the move-reweight leaves the
      siblings equal at t0 − 1, so the step read above is one later and
      every particle's term there is 0: it reads ln(N + 1);
    - ``ess_violations``, ``parents_bad``: as for object motion;
    - ``lml_gap``: |LML estimate − the grid's|;
    - ``posterior_gap``: |weighted mean of h_{T-1} − the grid's|."""
    dev = ans["log_weights"].device
    h = ans["latents"]["h"].double()
    yo = torch.as_tensor(y_obs, device=dev).double()
    s0 = stationary_sd(p)
    ll = lnorm(yo[:, None], 0.0, torch.exp(h / 2.0))
    prior = torch.cat([lnorm(h[:1], p["mu"], s0), lnorm(
        h[1:], p["mu"] + p["phi"] * (h[:-1] - p["mu"]), p["sigma"])])
    score = prior.sum(0) + ll.sum(0)
    scale = prior.abs().sum(0) + ll.abs().sum(0)
    lw = ans["log_weights"].double()
    cum, size = suffix_sums(ll), suffix_sums(ll.abs())
    parents = ans["parents"]
    if is_identity(parents):
        t0, mismatch, deficit = 0, 0, 0.0
        weight_gap = relative_gap(lw, cum[0], size[0])
    else:
        a, b = sibling_pairs(parents)
        fd = first_diff([h], a, b)
        # two moved siblings may draw one float32 value by chance; most
        # pairs first differ at the moved step
        first = int(torch.mode(fd).values) if fd.numel() else 0
        t0 = first + 1
        mismatch = int((fd < first).sum())
        offset = lw - cum[first]
        weight_gap = group_spread(offset, parents, size[first])
        moved = offset.abs() > MOVED_TOL * (1.0 + size[first])
        deficit = move_deficit(int(moved.sum()), lw.shape[0])
    lml, mean = grid(yo, p)
    return {
        "score_gap": relative_gap(ans["score"].double(), score, scale),
        "weight_gap": weight_gap,
        "sibling_mismatch": mismatch,
        "move_deficit": deficit,
        "ess_violations": ess_violations(lw, cum, t0, ess_frac),
        "parents_bad": parents_bad(parents),
        "lml_gap": abs(float(ans["lml"]) - lml),
        "posterior_gap": abs(weighted_mean(lw, h[-1]) - mean),
    }


def reference_filter(gen, y_obs, n: int, p, ess_frac: float,
                     method: str = "systematic",
                     dtype=torch.float32) -> dict:
    """The SV filter in plain PyTorch, every value and every step of
    arithmetic in ``dtype`` (a float32 filter's resampling sums in
    float64, see ``common``), drawing from ``gen`` on ``y_obs``'s device.
    Returns an answer as :func:`judge` takes it."""
    if method != "systematic":
        raise ValueError(f"the SV filter resamples systematically, not "
                         f"{method!r}")
    dev = y_obs.device
    yo = y_obs.to(dtype)
    t_max = yo.shape[0]
    s0 = stationary_sd(p)
    h = torch.zeros((t_max, n), dtype=dtype, device=dev)

    def draw(t):
        eps = torch.randn(n, generator=gen, device=dev).to(dtype)
        if t == 0:
            return p["mu"] + s0 * eps
        return p["mu"] + p["phi"] * (h[t - 1] - p["mu"]) + p["sigma"] * eps

    def lik(t, ht):
        return lnorm(yo[t], 0.0, torch.exp(ht / 2.0))

    log_n = torch.tensor(math.log(n), dtype=dtype, device=dev)
    h[0] = draw(0)
    lw = lik(0, h[0])
    lml = torch.zeros((), dtype=dtype, device=dev)
    parents = torch.arange(n, device=dev)
    for t in range(1, t_max):
        w = torch.softmax(lw, 0)
        if float(1.0 / torch.sum(w * w)) < ess_frac * n:
            lml = lml + torch.logsumexp(lw, 0) - log_n
            parents = systematic(gen, w)
            h[:t] = h[:t, parents]
            old = h[t - 1].clone()
            h[t - 1] = draw(t - 1)
            lw = lik(t - 1, h[t - 1]) - lik(t - 1, old)
        h[t] = draw(t)
        lw = lw + lik(t, h[t])
    score = lnorm(h[0], p["mu"], s0)
    for t in range(t_max):
        if t:
            score = score + lnorm(h[t], p["mu"] + p["phi"] * (h[t - 1]
                                                               - p["mu"]),
                                  p["sigma"])
        score = score + lik(t, h[t])
    return {"latents": {"h": h}, "log_weights": lw,
            "lml": lml + torch.logsumexp(lw, 0) - log_n,
            "parents": parents, "score": score}
