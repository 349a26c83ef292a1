"""Particle filter update: propagate every particle one step and
reweight, with the model's default proposal under ONE batched
interpretation. Translators, custom proposals and strata wait for later
slices."""

from __future__ import annotations

import torch

from ..core.choicemap import ChoiceMap, EMPTY
from ..core.gfi import batched_interpretation

__all__ = ["pf_update"]


def _check_no_discard(discard: ChoiceMap, check: bool):
    """An update that overwrote choices is not an extension: raise when
    checking and any discard entry is present. Static-True masks are
    decided on the host; tensor masks are read from the device."""
    if not check:
        return
    for addr, e in discard.entries.items():
        if e.mask is True or (e.mask is not False
                              and bool(torch.any(e.mask))):
            raise ValueError(
                f"pf_update discarded the choice at {addr}: an update "
                "must only extend the trace")


def pf_update(gen, state, new_args, argdiffs,
              observations: ChoiceMap = EMPTY, check: bool | None = None):
    """Propagate every particle one step and reweight. Returns a new
    state."""
    traces = state.traces
    if not getattr(traces.gen_fn, "batch_safe", False):
        raise NotImplementedError(
            "only batch_safe models are ported (batched interpretation)")
    with batched_interpretation(state.n_particles):
        new_traces, ws, _, discard = traces.gen_fn.update(
            gen, traces, new_args, argdiffs, observations)
    _check_no_discard(discard, True if check is None else check)
    return state.replace(traces=new_traces,
                         log_weights=state.log_weights + ws)
