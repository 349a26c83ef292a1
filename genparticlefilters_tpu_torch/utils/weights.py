"""Log-weight math: lognorm / softmax / safe_softmax and ESS.

``safe_softmax`` returns ``(weights, invalid)``: NaN inputs give NaN
weights, an all ``-inf`` vector gives uniform weights, both flagged
invalid. The flag stays a device tensor; only :func:`apply_check` with a
policy other than ``False`` reads it on the host.
"""

from __future__ import annotations

import torch

__all__ = ["logsumexp", "lognorm", "softmax", "safe_softmax",
           "ess_from_log_weights", "apply_check", "log_float32"]


def logsumexp(x):
    """log Σ exp over the last axis (``-inf`` for an all ``-inf`` row)."""
    return torch.logsumexp(x, dim=-1)


def log_float32(n, device):
    """``log(n)`` computed in float32 on ``device``, as the JAX package
    computes ``jnp.log(float(n))`` with 64-bit mode off. ``n`` enters by a
    fill kernel, not a host-to-device copy (which would sync)."""
    return torch.log(torch.full((), float(n), dtype=torch.float32,
                                device=device))


def lognorm(vs):
    """Log-normalize a vector of log weights."""
    return vs - logsumexp(vs)


def softmax(vs):
    """Softmax of (unnormalized) log probabilities."""
    ws = torch.exp(vs - torch.max(vs))
    return ws / torch.sum(ws)


def safe_softmax(vs):
    """Returns ``(weights, invalid)`` over the last axis (each row of a
    ``[K, b]`` matrix on its own, ``invalid`` then ``[K]``):

    - any NaN input          -> NaN weights, invalid
    - all inputs are -inf    -> uniform weights, invalid
    - otherwise              -> normalized weights, valid
    """
    n = vs.shape[-1]
    any_nan = torch.any(torch.isnan(vs), dim=-1, keepdim=True)
    m = torch.max(vs, dim=-1, keepdim=True).values
    all_neginf = m == -torch.inf
    zero = torch.zeros((), dtype=vs.dtype, device=vs.device)
    safe_vs = torch.where(all_neginf | any_nan, zero, vs - m)
    ws = torch.exp(safe_vs)
    norm = ws / torch.sum(ws, dim=-1, keepdim=True)
    uniform = torch.full((), 1.0 / n, dtype=vs.dtype, device=vs.device)
    out = torch.where(all_neginf, uniform, norm)
    out = torch.where(any_nan, torch.full_like(out, torch.nan), out)
    return out, (any_nan | all_neginf).squeeze(-1)


def ess_from_log_weights(log_weights):
    """Effective sample size 1/Σ ŵ²."""
    lw = lognorm(log_weights)
    return torch.exp(-logsumexp(2.0 * lw))


def apply_check(invalid, check):
    """The ``check`` policy for invalid weights: ``True`` raises,
    ``"warn"`` prints a warning, ``False`` is silent (and reads nothing
    from the device). Inside a ``vmap_gfi`` map the read waits until the
    map returns."""
    if check is False:
        return
    from ..core.batching import check_later

    def on_set():
        if check is True:
            raise FloatingPointError("Invalid weights (NaN or all -inf).")
        print("[genparticlefilters_tpu_torch] warning: invalid normalized "
              "weights (NaN or all -inf); renormalized per safe_softmax "
              "policy.")
    check_later(invalid, on_set)
