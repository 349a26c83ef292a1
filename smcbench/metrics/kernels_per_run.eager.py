"""kernels_per_run.eager: device operations (kernels, copies, sets) the
profiler recorded in the traced window, per run."""


def read(rec):
    if (rec.trace is None or rec.program.captured is not None
            or not rec.trace.device):
        return None
    return len(rec.trace.device) / rec.trace.runs
