"""Profiling hooks: a ``torch.profiler`` trace of a block and a wall-clock
timer that waits for the device."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace_profile", "Timer"]


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Profile the enclosed block (host, and the card when there is one)
    and write a Chrome trace, ``trace.json`` under ``logdir`` (open it in
    Perfetto or chrome://tracing). Yields the profiler, whose
    ``key_averages()`` gives the per-op table."""
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _devices(result):
    from ..core.tree import tree_leaves
    return {x.device for x in tree_leaves(result)
            if isinstance(x, torch.Tensor) and x.device.type == "cuda"}


class Timer:
    """Wall-clock timer. ``stop(result)`` first waits for every card that
    holds a tensor of ``result`` (a tree), so the time covers the device
    work that produced it."""

    def __init__(self):
        self.elapsed = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0

    def stop(self, result=None):
        if result is not None:
            for d in _devices(result):
                torch.cuda.synchronize(d)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed
