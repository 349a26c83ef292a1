"""max_scans_per_run.graph: runs of ``max_scan_kernel`` (G5, the running
maxima that keep the resample verb's hit counts and brackets monotone)
per filter run, counted on the card by the kernel itself over the whole
window of a captured graph. Nothing where the program has no such
kernel or counter."""


def _runs(reset=False):
    try:
        from genparticlefilters_tpu_torch.ops.max_scan import max_scan_runs
    except ImportError:
        return None
    return max_scan_runs(reset=reset)


def start(rec):
    if rec.program.captured is not None:
        _runs(reset=True)


def stop(rec):
    if rec.program.captured is not None:
        runs = _runs()
        if runs is not None:
            rec.notes["max_scan_runs"] = runs


def read(rec):
    if "max_scan_runs" not in rec.notes:
        return None
    return rec.notes["max_scan_runs"] / len(rec.runs)
