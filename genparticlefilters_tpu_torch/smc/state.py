"""Particle filter state container and diagnostics.

The state is a plain value object: batched traces (particle axis per
``trace_axes``), ``log_weights [N]``, the running log-marginal-likelihood
estimate and ``parents [N]``. Verbs return new states. Sub-state views
wait for a later slice.
"""

from __future__ import annotations

import torch

from ..core.gfi import Trace
from ..utils.weights import (softmax, ess_from_log_weights, logsumexp,
                             log_float32)

__all__ = ["ParticleFilterState", "pf_state", "get_norm_weights",
           "effective_sample_size", "log_ml_estimate", "batched_choice"]


class ParticleFilterState:
    """traces + log_weights [N] + log_ml_est + parents [N]."""

    __slots__ = ("traces", "log_weights", "log_ml_est", "parents")

    def __init__(self, traces: Trace, log_weights, log_ml_est, parents):
        self.traces = traces
        self.log_weights = log_weights
        self.log_ml_est = log_ml_est
        self.parents = parents

    # tree protocol (core/tree.py): the JAX package's leaf order
    def tree_flatten(self):
        return ((self.traces, self.log_weights, self.log_ml_est,
                 self.parents), None)

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)

    @property
    def n_particles(self) -> int:
        return int(self.log_weights.shape[0])

    def replace(self, **kw) -> "ParticleFilterState":
        vals = {s: getattr(self, s) for s in self.__slots__}
        vals.update(kw)
        return ParticleFilterState(**vals)

    def __repr__(self):
        return f"ParticleFilterState(n={self.n_particles})"


def pf_state(traces: Trace, log_weights=None) -> ParticleFilterState:
    """A state from batched traces, with zero LML and identity parents."""
    n = int(traces.score.shape[0])
    device = traces.score.device
    if log_weights is None:
        log_weights = torch.zeros((n,), dtype=torch.float32, device=device)
    return ParticleFilterState(
        traces, log_weights.to(torch.float32),
        torch.zeros((), dtype=torch.float32, device=device),
        torch.arange(n, dtype=torch.int32, device=device))


def get_norm_weights(state):
    return softmax(state.log_weights)


def effective_sample_size(state):
    """ESS = 1/Σ ŵ² (a device scalar)."""
    return ess_from_log_weights(state.log_weights)


def log_ml_estimate(state):
    """``log_ml_est + logsumexp(w) − log n`` (Gen's estimator)."""
    lw = state.log_weights
    return (state.log_ml_est + logsumexp(lw)
            - log_float32(state.n_particles, lw.device))


def batched_choice(state, addr):
    """Per-particle values at ``addr`` as ``[N, ...]``, particle-first
    whatever the storage layout; int components of ``addr`` index the
    combinator (time) axis. Sites stored shared across particles are
    broadcast to ``[N, ...]``."""
    traces = state.traces
    choices = traces.get_choices()
    axes = traces.gen_fn.trace_choice_axes(traces, 0)
    n = state.n_particles
    loc = choices.locate(addr)
    if loc is None:
        raise KeyError(addr)
    key, idxs, e = loc
    v = e.value
    ax = axes.get(key, 0)
    if v.dim() > ax and v.shape[ax] == n:
        v = torch.movedim(v, ax, 0)
        return v[(slice(None),) + idxs] if idxs else v
    v = v[idxs] if idxs else v
    return v.expand((n,) + tuple(v.shape))
