"""The arithmetic of the end-to-end metrics.

A window is the list of its runs, each ``(start, end)`` in host seconds:
a rate is taken over all the work and all the time of the window, a
tail over every run.
"""

from __future__ import annotations

import statistics


def window_seconds(runs) -> float:
    """From the first run's start to the last run's end."""
    return runs[-1][1] - runs[0][0]


def rate(runs, work_per_run: float) -> float:
    """Work completed per second over the whole window."""
    return work_per_run * len(runs) / window_seconds(runs)


def percentile(values, q: int) -> float:
    """The ``q``-th percentile (1 <= q <= 99) of every value, linearly
    interpolated between order statistics (``statistics.quantiles``,
    inclusive method)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def run_ms(runs):
    return [(end - start) * 1e3 for start, end in runs]


def p95_ms(runs) -> float:
    """The 95th percentile of the runs' wall times, in ms."""
    return percentile(run_ms(runs), 95)
