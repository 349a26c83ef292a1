"""The stochastic-volatility configuration: its pool of return series and
the entry the window drives.

- :func:`pool`: ``traffic["pool"]`` series of ``t_max`` returns drawn
  from the model on the device from the seed;
- :class:`Program`: ``sv_particle_filter`` on ``traffic["path"]``:
  ``graph`` captures it once (``capture``) and replays it per run with
  the run's series, ``eager`` calls it.
"""

from __future__ import annotations

import math

import torch


def pool(cell, seed: int, device) -> torch.Tensor:
    """``[P, T]`` float32 return series from ``seed``."""
    p, size = cell.config, cell.traffic["pool"]
    gen = torch.Generator(device=device).manual_seed(seed)
    eps = torch.randn((2, size, p["t_max"]), generator=gen, device=device)
    s0 = p["sigma"] / math.sqrt(1.0 - p["phi"] ** 2)
    h = [p["mu"] + s0 * eps[0, :, 0]]
    for t in range(1, p["t_max"]):
        h.append(p["mu"] + p["phi"] * (h[-1] - p["mu"])
                 + p["sigma"] * eps[0, :, t])
    return torch.exp(torch.stack(h, 1) / 2.0) * eps[1]


class Program:
    """The system under test for one cell, set up: built, captured where
    the path is ``graph``, and warmed on every branch."""

    latents = ("h",)

    def __init__(self, cell, gen: torch.Generator, seqs: torch.Tensor):
        from genparticlefilters_tpu_torch.ops.build import load_all
        from genparticlefilters_tpu_torch.models import (
            stochastic_volatility as sv)
        p, t = cell.config, cell.traffic
        if t["resample_method"] != p["resample_method"]:
            raise ValueError(f"the SV filter resamples "
                             f"{p['resample_method']}ly")
        self.path = t["path"]
        self.fn = sv.sv_particle_filter
        self.args = (t["particles"], p["t_max"],
                     sv.SVParams(p["mu"], p["phi"], p["sigma"]))
        self.kw = {"ess_frac": t["ess_frac"], "rejuv_steps": p["rejuv_steps"],
                   "rejuv_window": p["rejuv_window"]}
        self.captured = None
        self.capture_seconds = None
        self._gen = gen
        if gen.device.type == "cuda":
            load_all()
        if self.path == "graph":
            from genparticlefilters_tpu_torch.smc.capture import capture
            self.captured = capture(self.fn, gen, seqs[0], *self.args,
                                    **self.kw)
            self.capture_seconds = self.captured.capture_seconds
        elif self.path == "eager":
            self.fn(gen, seqs[0], *self.args, **dict(self.kw,
                                                     ess_frac=math.inf))
        else:
            raise ValueError(f"path {self.path!r}: graph or eager")

    def run(self, seq):
        """One filter run over ``seq``; returns the final state."""
        if self.captured is not None:
            return self.captured(seq)
        return self.fn(self._gen, seq, *self.args, **self.kw)

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
