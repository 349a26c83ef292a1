"""idle_share.eager: 1 − the union of the profiler's device operations ÷
the traced window, in % (eager runs have no IF bodies, whose records the
profiler drops)."""


def read(rec):
    if (rec.trace is None or rec.program.captured is not None
            or not rec.trace.device):
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
