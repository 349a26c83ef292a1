"""run_ms_p95: the 95th percentile of every run's wall time in the window,
ms, in a cell whose runs replay a captured graph."""

from smcbench.harness import stats


def read(rec):
    return stats.p95_ms(rec.runs)
