"""Plain helpers the references share: float64 log densities, the
checks of a particle filter's answer that hold whatever the model, and
the resampling of the reference filters.

Nothing here imports the program. Every check takes the answer as
tensors (on any device), casts it to float64 and recomputes from the
latents alone.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)

#: an ESS this far (relative) below the threshold at a check the program
#: did not branch on is a violation; float32 weights move the ESS by
#: about 1e-5 of itself, so a sound run never comes near it
ESS_SLACK = 1e-3


def lnorm(x, mean, sd):
    """log N(x; mean, sd), elementwise, in the dtype of ``x``."""
    z = (x - mean) / sd
    return -0.5 * z * z - torch.log(torch.as_tensor(sd, dtype=x.dtype,
                                                    device=x.device)) \
        - 0.5 * LOG_2PI


def suffix_sums(ll):
    """``cum[t] = ll[t:].sum(0)`` for t in 0..T, ``cum[T] = 0`` ([T+1, N])."""
    zero = torch.zeros_like(ll[:1])
    return torch.cat([torch.flip(torch.cumsum(torch.flip(ll, (0,)), 0),
                                 (0,)), zero])


def ess(lw):
    """1 / Σ ŵ² of float64 log weights."""
    w = torch.softmax(lw, 0)
    return float(1.0 / torch.sum(w * w))


def is_identity(parents) -> bool:
    n = parents.shape[0]
    return bool(torch.equal(parents.long(),
                            torch.arange(n, device=parents.device)))


def parents_bad(parents) -> int:
    """Parents outside [0, N)."""
    n = parents.shape[0]
    p = parents.long()
    return int(((p < 0) | (p >= n)).sum())


def sibling_pairs(parents):
    """(a, b): index pairs of particles with one parent, each particle
    paired with the next of its group in particle order."""
    p = parents.long()
    order = torch.sort(p, stable=True).indices
    ps = p[order]
    same = ps[1:] == ps[:-1]
    return order[:-1][same], order[1:][same]


def first_diff(latents, a, b):
    """For each pair (a, b): the first step at which any latent of the two
    particles differs, T where none does."""
    t_max = latents[0].shape[0]
    diff = torch.zeros((t_max, a.shape[0]), dtype=torch.bool,
                       device=a.device)
    for x in latents:
        diff |= x[:, a] != x[:, b]
    steps = torch.arange(t_max, device=a.device).unsqueeze(1)
    return torch.where(diff, steps, t_max).amin(0)


def relative_gap(got, want, scale) -> float:
    """The largest ``|got − want| / (1 + scale)``: a gap as a share of the
    magnitude of the terms summed into ``want`` (``scale``, the sum of
    their absolute values), so that float32 rounding reads alike on a
    particle of small and of large log density."""
    return float(((got - want).abs() / (1.0 + scale)).max())


def group_spread(values, parents, scale) -> float:
    """The largest (max − min) of ``values`` within one parent's group,
    over 1 + the group's largest ``scale`` (see :func:`relative_gap`)."""
    p = parents.long().clamp(0, parents.shape[0] - 1)
    n = values.shape[0]

    def reduce(x, how, fill):
        out = torch.full((n,), fill, dtype=x.dtype, device=x.device)
        return out.scatter_reduce(0, p, x, how)
    hi = reduce(values, "amax", -math.inf)
    lo = reduce(values, "amin", math.inf)
    top = reduce(scale, "amax", -math.inf)
    used = torch.isfinite(hi)
    if not bool(used.any()):
        return 0.0
    return float(((hi - lo) / (1.0 + top))[used].max())


def ess_violations(lw, cum, t0: int, ess_frac: float) -> int:
    """Checks after the last resample (steps t0+1 .. T-1) at which the
    filter should have branched: the ESS of the weights it held there,
    ``lw − cum[t]``, below ``ess_frac · N`` by more than the slack."""
    n = lw.shape[0]
    thr = ess_frac * n * (1.0 - ESS_SLACK)
    t_max = cum.shape[0] - 1
    return sum(ess(lw - cum[t]) < thr for t in range(t0 + 1, t_max))


def move_deficit(moved: int, total: int) -> float:
    """−ln((moved + 1) / (total + 1)): near 0 where the rejuvenation moved
    most of what it had to move, ln(total + 1) where it moved none."""
    return -math.log((moved + 1) / (total + 1))


def weighted_mean(lw, x):
    return float(torch.sum(torch.softmax(lw, 0) * x))


# ---------------------------------------------------------------------------
# the reference filters' resampling
# ---------------------------------------------------------------------------
#
# A float32 filter (the sound reference) takes its prefix sums and points
# in float64: a float32 prefix sum taken in parallel on the card can give
# a particle of weight 0 a bracket one ulp wide, and a parent drawn there
# carries a move-reweight ratio of e^20 and more into the LML. A filter in
# a lower precision (the control) takes them in its own dtype, as a port
# to that precision would.

def _sums_dtype(w):
    return torch.float64 if w.dtype.itemsize >= 4 else w.dtype


def _uniform(shape, gen, device, dtype):
    """Uniforms in ``dtype``: drawn in float64 for float64, else drawn in
    float32 and rounded."""
    if dtype == torch.float64:
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)
    return torch.rand(shape, generator=gen, device=device).to(dtype)


def systematic(gen, w):
    """Systematic resampling of normalized weights ``w`` [N]: sorted
    parents [N] (int64). The points are spread over the prefix sum's own
    total, so none falls past it onto particle N − 1."""
    n, acc = w.shape[0], _sums_dtype(w)
    u0 = _uniform((), gen, w.device, acc)
    c = torch.cumsum(w.to(acc), 0)
    u = (torch.arange(n, device=w.device).to(acc) + u0) / n * c[-1]
    return torch.searchsorted(c, u).clamp_(0, n - 1)


def residual(gen, w):
    """Residual resampling: ⌊N·w⌋ copies of each particle (``w`` in its
    own dtype), then multinomial draws of the remainder on the residual
    fractions; sorted parents [N] (int64)."""
    n, acc = w.shape[0], _sums_dtype(w)
    scaled = n * w
    det = torch.floor(scaled).clamp_(min=0)
    counts = det.to(torch.int64)
    base = torch.repeat_interleave(torch.arange(n, device=w.device),
                                   counts)[:n]
    n_res = n - base.shape[0]
    resid = (scaled - det).clamp_(min=0).to(acc)
    c = torch.cumsum(resid, 0)
    u = torch.sort(_uniform((n_res,), gen, w.device, torch.float64
                            if acc == torch.float64 else torch.float32)
                   ).values.to(acc) * c[-1]
    extra = torch.searchsorted(c, u).clamp_(0, n - 1)
    return torch.sort(torch.cat([base, extra])).values
