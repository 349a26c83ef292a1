"""The reference filter put in the program's place: the control of the
check that decides ``correct``. In bfloat16, the precision below the
configuration's float32, it has to come out not correct; in float32 it
shows that the check passes a sound filter that is not the program."""

from __future__ import annotations

import importlib

import torch


class Control:
    """A ``Program`` (see ``configs/<config>.py``) that runs the
    configuration's ``reference_filter`` in ``dtype``."""

    captured = None
    capture_seconds = None

    def __init__(self, cell, gen, seqs, dtype=torch.bfloat16):
        self.ref = importlib.import_module(
            f"{__package__}.{cell.config_name}")
        self.cell, self.gen, self.dtype = cell, gen, dtype

    def run(self, seq):
        t = self.cell.traffic
        return self.ref.reference_filter(
            self.gen, seq, t["particles"], self.cell.config, t["ess_frac"],
            t["resample_method"], self.dtype)

    @staticmethod
    def answer(out):
        return out
