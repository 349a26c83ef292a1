"""Rejuvenation: the Metropolis–Hastings kernel (selection form) and the
move-accept sweep. The kernel regenerates the selected addresses through
the trace's delta protocol and accepts per particle with probability
``min(1, e^weight)``; weights are untouched. Custom proposals,
involutions and move-reweight wait for later slices."""

from __future__ import annotations

import torch

from ..core.choicemap import Selection
from ..core.gfi import NoChange, Trace, batched_interpretation

__all__ = ["mh", "pf_move_accept", "pf_rejuvenate"]


def mh(gen, trace: Trace, selection: Selection, window: int | None = None):
    """Metropolis–Hastings kernel: ``(new_trace, accept)``. The proposed
    trace is never materialized: ``regenerate_delta`` returns the window's
    new columns and ``apply_regenerate_delta`` writes them under the
    accept mask."""
    if not isinstance(selection, Selection):
        raise NotImplementedError(
            "only the selection form of mh is ported")
    args = trace.get_args()
    delta, w = trace.gen_fn.regenerate_delta(
        gen, trace, args, tuple(NoChange() for _ in args), selection,
        window=window)
    u = torch.rand(w.shape, generator=gen, dtype=torch.float32,
                   device=w.device)
    accept = torch.log(u) < w
    return trace.gen_fn.apply_regenerate_delta(trace, delta, accept), accept


def _sweeps(gen, traces, kern, kern_args, n_iters, kwargs):
    """Apply ``kern`` ``n_iters`` times to every particle under ONE batched
    interpretation; the kernels' per-particle accept flags are dropped."""
    with batched_interpretation(int(traces.score.shape[0])):
        for _ in range(n_iters):
            traces, _ = kern(gen, traces, *kern_args, **kwargs)
    return traces


def pf_move_accept(gen, state, kern=mh, kern_args=(), n_iters: int = 1,
                   **kwargs):
    """MCMC rejuvenation; weights untouched."""
    if not getattr(state.traces.gen_fn, "batch_safe", False):
        raise NotImplementedError(
            "only batch_safe models are ported (batched interpretation)")
    new_traces = _sweeps(gen, state.traces, kern, kern_args, n_iters,
                         kwargs)
    return state.replace(traces=new_traces)


def pf_rejuvenate(gen, state, kern=mh, kern_args=(), n_iters: int = 1,
                  method: str = "move", **kwargs):
    """Dispatcher; only ``method="move"`` is ported."""
    if method == "move":
        return pf_move_accept(gen, state, kern, kern_args, n_iters, **kwargs)
    if method == "reweight":
        raise NotImplementedError("move-reweight is not ported yet")
    raise ValueError(f"Method {method!r} not recognized.")
