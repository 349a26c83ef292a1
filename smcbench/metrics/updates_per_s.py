"""updates_per_s: particle updates (N·T per run) completed per second over
the whole window, in a cell whose runs replay a captured graph."""

from smcbench.harness import stats


def read(rec):
    return stats.rate(rec.runs, rec.work_per_run)
