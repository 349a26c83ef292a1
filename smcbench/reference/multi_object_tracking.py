"""Plain reference for the multi-object tracking cell (BASELINE config 5).

Model, with ``p`` the configuration's numbers: K objects, each an
independent 2-D Gaussian random walk, ``x_0 ~ N(0, s0)``, ``x_t ~
N(x_{t-1}, q)``, observed as ``y_t ~ N(x_t, r)``, every coordinate on its
own. The filter resamples systematically when the ESS falls below
``ess_frac`` times the count it holds, and resizes online on the
configuration's schedule (``resize_schedule``: a residual resize to N/2
before step T//3, a multinomial resize back to N before step 2T//3).

- :func:`exact`: the posterior mean of every coordinate at every step and
  log p(y_obs): the 2·K coordinates are independent, so this is 2·K scalar
  Kalman filters, in float64;
- :func:`judge`: the numbers ``correct`` compares, for one filter answer;
- :func:`reference_filter`: the config-5 filter written plainly (bootstrap
  proposals, systematic resampling, residual and multinomial resizes) in a
  given dtype; in bfloat16 it is the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (lnorm, suffix_sums, is_identity, sibling_pairs,
                     first_diff, relative_gap, ess, weighted_mean, ESS_SLACK,
                     LOG_2PI, _sums_dtype)

def schedule_of(p) -> dict:
    """The configuration's resize schedule as ``{t: (n_new, method)}``."""
    return {int(e["before_step"]): (int(e["particles"]), e["method"])
            for e in p.get("resize_schedule", ())}


def counts(n0: int, t_max: int, schedule) -> list:
    """``[(n entering step t, n after its resize)]`` for t in 0..T-1."""
    out, n = [], n0
    for t in range(t_max):
        before = n
        n = schedule[t][0] if t in schedule else n
        out.append((before, n))
    return out


def exact(y_obs, p):
    """(E[x_t | y_0..t] [T, K, 2], log p(y_obs)), float64 numpy: one scalar
    Kalman filter per coordinate."""
    yo = np.asarray(y_obs, np.float64)
    shape, t_max = yo.shape, yo.shape[0]
    yo = yo.reshape(t_max, -1)
    m = np.zeros(yo.shape[1])
    v = np.full(yo.shape[1], p["s0"] ** 2)
    lml, means = 0.0, []
    for t in range(t_max):
        if t:
            v = v + p["q"] ** 2
        s = v + p["r"] ** 2
        lml += float(np.sum(-0.5 * (yo[t] - m) ** 2 / s
                            - 0.5 * np.log(2 * math.pi * s)))
        gain = v / s
        m, v = m + gain * (yo[t] - m), v * (1 - gain)
        means.append(m)
    return np.stack(means).reshape(shape), lml


def exact_lml(y_obs, p) -> float:
    """log p(y_obs), float64, by :func:`exact`."""
    return exact(torch.as_tensor(y_obs).double().cpu().numpy(), p)[1]


def _terms(x, yo, p):
    """Per-coordinate log density terms of every step, float64: the
    transitions ``[T, N, D]`` and the observations ``[T, N, D]``."""
    zero = torch.zeros_like(x[:1])
    prev = torch.cat([zero, x[:-1]])
    sd = torch.full((x.shape[0], 1, 1), p["q"], dtype=x.dtype,
                    device=x.device)
    sd[0] = p["s0"]
    z = (x - prev) / sd
    steps = -0.5 * z * z - torch.log(sd) - 0.5 * LOG_2PI
    return steps, lnorm(yo, x, p["r"])


def judge(ans, y_obs, p, ess_frac: float, schedule=None) -> dict:
    """The numbers of one answer (see ``PERF.md`` for each); ``schedule``
    (``{t: (n_new, method)}``) defaults to the configuration's:

    - ``score_gap``: largest |trace score − the joint log density of the
      particle's latents and the observations|, over 1 + the sum of the
      absolute values of the density's terms;
    - ``weight_gap``: largest |log weight − Σ_{t ≥ t0} log p(y_t | x_t)|,
      relative as above, t0 the step of the last resampling or resize (0
      where neither happened): both reset the weights;
    - ``sibling_mismatch``: pairs of particles of one parent whose latents
      differ before step t0;
    - ``ess_violations``: checks after t0 at which the ESS of the weights
      then held was below ``ess_frac`` times the count then held, so the
      filter had to resample;
    - ``parents_bad``: parents outside [0, the count they index);
    - ``count_bad``: |final count − the schedule's|;
    - ``lml_gap``: |LML estimate − the exact log marginal likelihood|;
    - ``posterior_gap``: largest |weighted mean of x_{T-1} − the Kalman
      mean| over the 2·K coordinates."""
    sched = schedule_of(p) if schedule is None else dict(schedule)
    dev = ans["log_weights"].device
    x = ans["latents"]["x"].double()
    t_max, n = x.shape[0], x.shape[1]
    x = x.reshape(t_max, n, -1)
    yo = torch.as_tensor(y_obs, device=dev).double().reshape(t_max, 1, -1)
    steps, obs = _terms(x, yo, p)
    ll = obs.sum(-1)
    score = steps.sum((0, 2)) + ll.sum(0)
    scale = steps.abs().sum((0, 2)) + obs.abs().sum((0, 2))
    lw = ans["log_weights"].double()
    cum, size = suffix_sums(ll), suffix_sums(obs.abs().sum(-1))
    parents = ans["parents"]
    n0 = int(ans.get("particles", n))
    per_step = counts(n0, t_max, sched)
    if is_identity(parents) and not sched:
        t0, mismatch = 0, 0
        weight_gap = relative_gap(lw, cum[0], size[0])
    else:
        gaps = [relative_gap(lw, cum[t], size[t]) for t in range(1, t_max)]
        t0 = 1 + int(np.argmin(gaps))
        weight_gap = gaps[t0 - 1]
        a, b = sibling_pairs(parents)
        fd = first_diff([x[..., d] for d in range(x.shape[2])], a, b)
        mismatch = int((fd < t0).sum())
    # the parents index the state before step t0's resize, unless a
    # resample followed it (only where ess_frac >= 1: a resize leaves
    # equal weights, whose ESS is the count)
    before, after = per_step[t0]
    source = after if (t0 not in sched or ess_frac >= 1.0) else before
    p_long = parents.long()
    bad_parents = int(((p_long < 0) | (p_long >= source)).sum())
    want = per_step[-1][1]
    violations = sum(
        ess(lw - cum[t]) < ess_frac * per_step[t][1] * (1.0 - ESS_SLACK)
        for t in range(t0 + 1, t_max))
    mean, lml = exact(torch.as_tensor(y_obs).double().cpu().numpy(), p)
    last = mean[-1].reshape(-1)
    est = [weighted_mean(lw, x[t_max - 1, :, d]) for d in range(x.shape[2])]
    return {
        "score_gap": relative_gap(ans["score"].double(), score, scale),
        "weight_gap": weight_gap,
        "sibling_mismatch": mismatch,
        "ess_violations": violations,
        "parents_bad": bad_parents,
        "count_bad": abs(n - want),
        "lml_gap": abs(float(ans["lml"]) - lml),
        "posterior_gap": float(np.max(np.abs(np.array(est) - last))),
    }


# ---------------------------------------------------------------------------
# the reference filter's resampling and resizing
# ---------------------------------------------------------------------------
#
# As in ``common``: a float32 filter sums its prefix sums in float64 and
# rounds the brackets to float32; a filter in a lower precision sums in its
# own dtype. Sorted uniforms are cumulative exponential spacings, drawn in
# float32 (``e``, ``[m + 1]``, may be passed in).

def normalized(lw):
    """Normalized weights ``exp(lw − max) / Σ``, in ``lw``'s dtype."""
    w = torch.exp(lw - torch.max(lw))
    return w / torch.sum(w)


def _spacings(gen, m: int, device, e=None):
    """The float32 cumulative sums of ``m + 1`` Exponential(1) draws."""
    if e is None:
        e = torch.empty((m + 1,), dtype=torch.float32,
                        device=device).exponential_(generator=gen)
    return torch.cumsum(torch.as_tensor(e, dtype=torch.float32,
                                        device=device), 0)


def _brackets(w):
    """Normalized cumulative weights, summed in the accumulation dtype and
    rounded to ``w``'s."""
    c = torch.cumsum(w.to(_sums_dtype(w)), 0)
    return (c / c[-1]).to(w.dtype)


def systematic(gen, w, u0=None):
    """Systematic resampling of normalized weights ``w`` [N]: output j's
    parent is the number of particles whose N·cumsum(w) − u0 lies below
    j; sorted parents [N] (int64)."""
    n, acc = w.shape[0], _sums_dtype(w)
    if u0 is None:
        u0 = torch.rand((), generator=gen, device=w.device)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=w.device)
    x = n * torch.cumsum(w.to(acc), 0) - u0.to(acc)
    j = torch.arange(n, device=w.device).to(acc)
    return torch.searchsorted(x, j).clamp_(0, n - 1)


def multinomial_resize(gen, w, m: int, e=None):
    """Multinomial resize of ``w`` [N] to ``m`` draws: the m sorted
    uniforms ``ce[j] / ce[m]`` placed in the brackets; sorted parents
    [m] (int64)."""
    ce = _spacings(gen, m, w.device, e)
    u = torch.clamp_min(ce[:-1] / ce[-1], 1e-37).to(w.dtype)
    return torch.searchsorted(_brackets(w), u).clamp_(0, w.shape[0] - 1)


def residual_resize(gen, w, m: int, e=None):
    """Residual resize of ``w`` [N] to ``m``: ⌊m·w⌋ copies of each
    particle, then R = m − Σ⌊m·w⌋ sorted uniforms ``ce[j] / ce[R]`` placed
    in the brackets of the residual fractions; sorted parents [m]
    (int64)."""
    n = w.shape[0]
    scaled = m * w
    det = torch.floor(scaled).clamp_(min=0)
    base = torch.repeat_interleave(torch.arange(n, device=w.device),
                                   det.long())
    n_res = m - base.shape[0]
    ce = _spacings(gen, m, w.device, e)
    u = (ce[:n_res] / ce[n_res]).to(w.dtype)
    rc = _brackets((scaled - det).clamp_(min=0))
    extra = torch.searchsorted(rc, u, right=True).clamp_(0, n - 1)
    return torch.sort(torch.cat([base, extra])).values


RESIZES = {"residual": residual_resize, "multinomial": multinomial_resize}


def reference_filter(gen, y_obs, n: int, p, ess_frac: float, method: str,
                     dtype=torch.float32, schedule=None) -> dict:
    """The config-5 filter in plain PyTorch, every value and every step of
    arithmetic in ``dtype`` (a float32 filter's resampling sums in
    float64), drawing from ``gen`` on ``y_obs``'s device: before step t
    the schedule's resize (LML folded, weights reset), then systematic
    resampling where the ESS is below ``ess_frac`` times the count held,
    then the bootstrap step. Returns an answer as :func:`judge` takes
    it."""
    if method != "systematic":
        raise ValueError(f"the config-5 filter resamples systematically, "
                         f"not {method!r}")
    sched = schedule_of(p) if schedule is None else dict(schedule)
    dev = y_obs.device
    t_max = y_obs.shape[0]
    yo = y_obs.to(dtype).reshape(t_max, 1, -1)
    d = yo.shape[2]

    def noise(m):
        return torch.randn((m, d), generator=gen, device=dev).to(dtype)

    def loglik(t, xt):
        return lnorm(yo[t], xt, p["r"]).sum(-1)

    def log_n(m):
        return torch.tensor(math.log(m), dtype=dtype, device=dev)

    n0 = n
    xs = [p["s0"] * noise(n)]
    lw = loglik(0, xs[0])
    lml = torch.zeros((), dtype=dtype, device=dev)
    parents = torch.arange(n, device=dev)
    for t in range(1, t_max):
        picks = []
        if t in sched:
            m, how = sched[t]
            picks.append((lambda w, m=m, how=how: RESIZES[how](gen, w, m)))
        picks.append(None)
        for pick in picks:
            w = normalized(lw)
            if pick is None:
                if float(1.0 / torch.sum(w * w)) >= ess_frac * n:
                    continue
                pick = lambda w: systematic(gen, w)  # noqa: E731
            lml = lml + torch.logsumexp(lw, 0) - log_n(n)
            parents = pick(w)
            xs = [x[parents] for x in xs]
            n = parents.shape[0]
            lw = torch.zeros(n, dtype=dtype, device=dev)
        xs.append(xs[-1] + p["q"] * noise(n))
        lw = lw + loglik(t, xs[-1])
    score = lnorm(xs[0], 0.0, p["s0"]).sum(-1) + loglik(0, xs[0])
    for t in range(1, t_max):
        score = (score + lnorm(xs[t], xs[t - 1], p["q"]).sum(-1)
                 + loglik(t, xs[t]))
    x = torch.stack(xs).reshape((t_max, n) + tuple(y_obs.shape[1:]))
    return {"latents": {"x": x}, "log_weights": lw,
            "lml": lml + torch.logsumexp(lw, 0) - log_n(n),
            "parents": parents, "score": score, "particles": n0}
