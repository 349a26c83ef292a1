"""idle_share.graph: the share of the window in which no replay ran on the
card: 1 − Σ (CUDA-event time from just before to just after each run, on
its stream) ÷ the window, over the runs after the profiled ones, in %."""


def read(rec):
    if rec.program.captured is None or not rec.run_device_s:
        return None
    runs = rec.runs[rec.traced_runs:]
    spans = rec.run_device_s[rec.traced_runs:]
    if len(runs) < 2:
        return None
    window = runs[-1][1] - runs[0][0]
    return 100.0 * (1.0 - sum(spans) / window)
