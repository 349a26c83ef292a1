"""The multi-object tracking configuration (BASELINE config 5): its pool
of observation sequences and the entry the window drives.

- :func:`pool`: ``traffic["pool"]`` sequences ``[T, K, 2]`` drawn from the
  model on the device from the seed, in a few calls;
- :class:`Program`: the config-5 filter on ``traffic["path"]``, with the
  configuration's resize schedule: ``graph`` captures it once
  (``mot_particle_filter_captured``) and replays it per run with the
  run's sequence, ``eager`` calls ``mot_particle_filter``.
"""

from __future__ import annotations

import math

import torch

from smcbench.reference.multi_object_tracking import schedule_of


def pool(cell, seed: int, device) -> torch.Tensor:
    """``[P, T, K, 2]`` float32 observation sequences from ``seed``."""
    p, size = cell.config, cell.traffic["pool"]
    t_max, k = p["t_max"], p["n_objects"]
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((2, size, t_max, k, 2), generator=gen, device=device)
    sd = torch.full((t_max, 1, 1), p["q"], device=device)
    sd[0] = p["s0"]
    x = torch.cumsum(sd * eps[0], dim=1)
    return x + p["r"] * eps[1]


class Program:
    """The system under test for one cell, set up: built, captured where
    the path is ``graph``, and warmed on every branch."""

    latents = ("x",)

    def __init__(self, cell, gen: torch.Generator, seqs: torch.Tensor):
        # the captured entry first: a tree without it fails here, before
        # any kernel is built
        from genparticlefilters_tpu_torch.models.multi_object import (
            MOTParams, mot_particle_filter, mot_particle_filter_captured)
        from genparticlefilters_tpu_torch.ops.build import load_all
        p, t = cell.config, cell.traffic
        self.path = t["path"]
        self.particles = t["particles"]
        self.args = (t["particles"], p["t_max"],
                     MOTParams(p["n_objects"], p["q"], p["r"], p["s0"]))
        self.kw = {"ess_frac": t["ess_frac"],
                   "resample_method": t["resample_method"],
                   "resize_schedule": schedule_of(p)}
        self.captured = None
        self.capture_seconds = None
        self._gen = gen
        self._eager = mot_particle_filter
        if gen.device.type == "cuda":
            load_all()
        if self.path == "graph":
            self.captured = mot_particle_filter_captured(
                gen, seqs[0], *self.args, **self.kw)
            self.capture_seconds = self.captured.capture_seconds
        elif self.path == "eager":
            # every branch taken once, so that its kernels and buffers
            # meet the card before the window
            self._eager(gen, seqs[0], *self.args,
                        **dict(self.kw, ess_frac=math.inf))
        else:
            raise ValueError(f"path {self.path!r}: graph or eager")

    def run(self, seq):
        """One filter run over ``seq``; returns the final state."""
        if self.captured is not None:
            return self.captured(seq)
        return self._eager(self._gen, seq, *self.args, **self.kw)

    def answer(self, state) -> dict:
        """What the run returned, as tensors: the latents, the final log
        weights, the LML estimate, the parents and the trace scores, with
        the count the run started from."""
        from genparticlefilters_tpu_torch import log_ml_estimate
        choices = state.traces.get_choices()
        return {"latents": {k: choices[(k,)] for k in self.latents},
                "log_weights": state.log_weights,
                "lml": log_ml_estimate(state), "parents": state.parents,
                "score": state.traces.score, "particles": self.particles}
