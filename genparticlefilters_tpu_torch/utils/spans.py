"""Named ``torch.profiler`` spans for the phases of a filter run."""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["span"]


def span(name):
    """A named ``torch.profiler`` span while a profiler runs, else nothing:
    an unprofiled ``record_function`` costs ~15 µs of host time per span
    on a slow host, the guard under 1 µs."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()
