"""Faults planted in the program's own functions, for the tests and the
calibration that show the check catching them.

- ``unchanged_step``: the update verb returns its state unchanged;
- ``half_batch``: the resampler sees half of the particles, the LML taken
  over the rest;
- ``altered_answer``: one particle's log weight and trace score altered
  where the filter returns them;
- ``skipped_resample``: the resampler returns its state unchanged (an
  ESS check that fires and does nothing);
- ``skipped_rejuvenation``: the rejuvenation after a resample (object
  motion's MH, SV's move-reweight) returns its state unchanged;
- ``shifted_parents``: the parents returned one place out of line;
- ``parent_out_of_range``: one parent returned as N.

Each is planted before the cell is set up, so a captured graph holds it.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import torch

OM = "genparticlefilters_tpu_torch.models.object_motion"
SV = "genparticlefilters_tpu_torch.models.stochastic_volatility"
#: config -> (module whose verbs the filter calls, (module, name) of the
#: rejuvenation the filter calls, (module, name) of the eager filter)
WHERE = {"object_motion": (OM, (OM, "pf_rejuvenate"),
                           (OM, "object_motion_filter")),
         "stochastic_volatility": ("genparticlefilters_tpu_torch.smc."
                                   "algorithms", (SV, "pf_move_reweight"),
                                   (SV, "sv_particle_filter"))}
#: a captured run's entry
CAPTURED = ("genparticlefilters_tpu_torch.smc.capture", "CapturedRun",
            "__call__")
FAULTS = ("unchanged_step", "half_batch", "altered_answer",
          "skipped_resample", "skipped_rejuvenation", "shifted_parents",
          "parent_out_of_range")
#: the number that must read above its limit under each fault that one
#: number alone catches
CAUGHT_BY = {"skipped_resample": "ess_violations",
             "skipped_rejuvenation": "move_deficit",
             "shifted_parents": "sibling_mismatch",
             "parent_out_of_range": "parents_bad"}


def _unchanged(gen, state, *a, **k):
    return state


def _half(inner):
    def resample(gen, state, *a, **k):
        lw = state.log_weights.clone()
        lw[lw.shape[0] // 2:] = -math.inf
        return inner(gen, state.replace(log_weights=lw), *a, **k)
    return resample


def _returned(inner, change):
    """``inner`` with ``change(state)`` applied to what it returns."""
    def entry(*a, **k):
        return change(inner(*a, **k))
    return entry


def _altered(state):
    lw = state.log_weights.clone()
    lw[0] += 0.5
    state.traces.score[0] += 0.5
    return state.replace(log_weights=lw)


def _shifted(state):
    return state.replace(parents=torch.roll(state.parents, 1))


def _out_of_range(state):
    parents = state.parents.clone()
    parents[0] = parents.shape[0]
    return state.replace(parents=parents)


CHANGES = {"altered_answer": _altered, "shifted_parents": _shifted,
           "parent_out_of_range": _out_of_range}


@contextlib.contextmanager
def planted(cell, fault):
    """``fault`` planted in the program while the block runs."""
    verbs_mod, (rejuv_mod, rejuv), (entry_mod, entry) = WHERE[
        cell.config_name]
    verbs = importlib.import_module(verbs_mod)
    if fault == "unchanged_step":
        target, name, new = verbs, "pf_update", _unchanged
    elif fault == "half_batch":
        target, name = verbs, "pf_resample"
        new = _half(verbs.pf_resample)
    elif fault == "skipped_resample":
        target, name, new = verbs, "pf_resample", _unchanged
    elif fault == "skipped_rejuvenation":
        target, name = importlib.import_module(rejuv_mod), rejuv
        new = _unchanged
    else:
        if cell.traffic["path"] == "graph":
            mod, cls, name = CAPTURED
            target = getattr(importlib.import_module(mod), cls)
        else:
            target, name = importlib.import_module(entry_mod), entry
        new = _returned(getattr(target, name), CHANGES[fault])
    old = getattr(target, name)
    setattr(target, name, new)
    try:
        yield
    finally:
        setattr(target, name, old)
