"""Particle filter state container, views and diagnostics.

The state is a plain value object: batched traces (particle axis per
``trace_axes``), ``log_weights [N]``, the running log-marginal-likelihood
estimate and ``parents [N]``. Verbs return new states. ``state[idxs]`` is
a :class:`ParticleFilterSubState`, a view of a block of particles: block
operations read the block, work on it and write it back into a copy of
the source, which itself is never written in place.
"""

from __future__ import annotations

import torch

from ..core.batching import tree_take, tree_put
from ..core.gfi import Trace
from ..utils.weights import (lognorm, softmax, ess_from_log_weights,
                             logsumexp, log_float32)

__all__ = ["ParticleFilterState", "ParticleFilterSubState",
           "ParticleFilterView", "pf_state", "get_traces",
           "get_log_weights", "get_parents", "get_log_norm_weights",
           "get_norm_weights", "effective_sample_size", "get_ess",
           "log_ml_estimate", "get_lml_est", "sample_unweighted_traces",
           "num_particles", "batched_choice"]


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

    def view(self, idxs) -> "ParticleFilterSubState":
        return ParticleFilterSubState(self, idxs)

    def __getitem__(self, idxs):
        return self.view(idxs)

    def __repr__(self):
        return f"ParticleFilterState(n={self.n_particles})"


class ParticleFilterSubState:
    """A view of the particles ``idxs`` (a slice or an index vector) of a
    state. Block operations return the updated source state."""

    __slots__ = ("source", "idxs")

    def __init__(self, source: ParticleFilterState, idxs):
        device = source.log_weights.device
        if isinstance(idxs, slice):
            idxs = torch.arange(source.n_particles, device=device)[idxs]
        self.source = source
        self.idxs = torch.as_tensor(idxs, device=device).to(torch.int32)

    @property
    def n_particles(self) -> int:
        return int(self.idxs.shape[0])

    @property
    def traces(self) -> Trace:
        return tree_take(self.source.traces, self.idxs)

    @property
    def log_weights(self):
        return torch.index_select(self.source.log_weights, 0,
                                  self.idxs.long())

    @property
    def parents(self):
        return torch.index_select(self.source.parents, 0, self.idxs.long())

    def scatter(self, traces=None, log_weights=None, parents=None
                ) -> ParticleFilterState:
        """A new source state with the block's values written back."""
        src = self.source
        idx = self.idxs.long()
        new_traces = (src.traces if traces is None
                      else tree_put(src.traces, traces, self.idxs))
        lw = (src.log_weights if log_weights is None
              else src.log_weights.index_copy(0, idx, log_weights))
        pr = (src.parents if parents is None
              else src.parents.index_copy(0, idx, parents.to(torch.int32)))
        return ParticleFilterState(new_traces, lw, src.log_ml_est, pr)

    def __repr__(self):
        return f"ParticleFilterSubState(n={self.n_particles})"


#: isinstance-union of full states and views
ParticleFilterView = (ParticleFilterState, ParticleFilterSubState)


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


def get_traces(state):
    return state.traces


def get_log_weights(state):
    return state.log_weights


def get_parents(state):
    return state.parents


def num_particles(state):
    return state.n_particles


def get_log_norm_weights(state):
    """Normalized log weights."""
    return lognorm(state.log_weights)


def get_norm_weights(state):
    return softmax(state.log_weights)


def effective_sample_size(state):
    """ESS = 1/Σ ŵ² (a device scalar)."""
    return ess_from_log_weights(state.log_weights)


get_ess = effective_sample_size


def log_ml_estimate(state):
    """Full state: ``log_ml_est + logsumexp(w) − log n`` (Gen's
    estimator). Sub-state: the source's ``log_ml_est`` plus the block's
    ``logsumexp(w_block) − log n_block``."""
    lw = state.log_weights
    base = (state.source.log_ml_est
            if isinstance(state, ParticleFilterSubState)
            else state.log_ml_est)
    return base + logsumexp(lw) - log_float32(state.n_particles, lw.device)


get_lml_est = log_ml_estimate


def sample_unweighted_traces(gen, state, n_samples: int) -> Trace:
    """``n_samples`` traces drawn i.i.d. by normalized weight. The
    multinomial draws come out in clustered (index-sorted) order, so the
    slots are permuted at random (from ``gen``): any prefix of the result
    is itself an i.i.d. sample."""
    from .resample import multinomial_parents
    idx = multinomial_parents(gen, get_norm_weights(state), n_samples)
    perm = torch.randperm(n_samples, generator=gen, device=idx.device)
    return tree_take(state.traces, idx[perm])


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
