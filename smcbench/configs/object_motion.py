"""The object-motion configuration: its pool of observation sequences and
the entry the window drives.

- :func:`pool`: ``traffic["pool"]`` sequences of ``t_max`` observations,
  drawn on the device from the seed in a few calls. Each seed gets the same
  switch times (every value of 1..T-1 equally often), in its own order,
  so that seeds change the noise and not the mix of work.
- :class:`Program`: the filter on ``traffic["path"]``: ``graph``
  captures it once (``object_motion_filter_captured``) and replays it per
  run with the run's sequence, ``eager`` calls ``object_motion_filter``.
"""

from __future__ import annotations

import math

import torch


def pool(cell, seed: int, device) -> torch.Tensor:
    """``[P, T]`` float32 observation sequences from ``seed``."""
    p, size = cell.config, cell.traffic["pool"]
    t_max = p["t_max"]
    if size % (t_max - 1):
        raise ValueError(f"pool {size} is not a multiple of the {t_max - 1} "
                         f"switch times")
    gen = torch.Generator(device=device).manual_seed(seed)
    switch = torch.arange(1, t_max, device=device).repeat(size // (t_max - 1))
    switch = switch[torch.randperm(size, generator=gen, device=device)]
    steps = torch.arange(t_max, device=device)
    moving = steps[None, :] >= switch[:, None]
    vel = torch.sin(steps.to(torch.float64) + 1.0).to(torch.float32)
    eps = torch.randn((2, size, t_max), generator=gen, device=device)
    y = torch.cumsum(moving * vel + p["y_sd"] * eps[0], dim=1)
    return y + p["obs_sd"] * eps[1]


class Program:
    """The system under test for one cell, set up: built, captured where
    the path is ``graph``, and warmed on every branch."""

    latents = ("moving", "y")

    def __init__(self, cell, gen: torch.Generator, seqs: torch.Tensor):
        from genparticlefilters_tpu_torch.ops.build import load_all
        from genparticlefilters_tpu_torch.models import object_motion as om
        t = cell.traffic
        self.path = t["path"]
        self.args = (t["particles"], cell.config["t_max"])
        self.kw = {"ess_frac": t["ess_frac"],
                   "resample_method": t["resample_method"]}
        self.captured = None
        self.capture_seconds = None
        if gen.device.type == "cuda":
            load_all()
        if self.path == "graph":
            self.captured = om.object_motion_filter_captured(
                gen, seqs[0], *self.args, **self.kw)
            self.capture_seconds = self.captured.capture_seconds
        elif self.path == "eager":
            self._eager = om.object_motion_filter
            self._gen = gen
            # every branch taken once, so that its kernels and buffers
            # meet the card before the window
            self._eager(gen, seqs[0], *self.args, ess_frac=math.inf,
                        resample_method=t["resample_method"])
        else:
            raise ValueError(f"path {self.path!r}: graph or eager")

    def run(self, seq):
        """One filter run over ``seq``; returns the final state."""
        if self.captured is not None:
            return self.captured(seq)
        return self._eager(self._gen, seq, *self.args, **self.kw)

    @staticmethod
    def answer(state) -> dict:
        """What the run returned, as tensors: the latents, the final log
        weights, the LML estimate, the parents and the trace scores."""
        from genparticlefilters_tpu_torch import log_ml_estimate
        choices = state.traces.get_choices()
        return {"latents": {k: choices[(k,)] for k in Program.latents},
                "log_weights": state.log_weights,
                "lml": log_ml_estimate(state), "parents": state.parents,
                "score": state.traces.score}
