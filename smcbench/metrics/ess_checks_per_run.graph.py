"""ess_checks_per_run.graph: runs of ``ess_check_kernel`` (the ESS check
of an unsharded state: one kernel computes the resample predicate from
the log weights) per filter run, counted on the card by the kernel itself
over the whole window of a captured graph. Nothing where the program has
no such kernel or counter."""


def _runs(reset=False):
    try:
        from genparticlefilters_tpu_torch.ops.ess_check import ess_check_runs
    except ImportError:
        return None
    return ess_check_runs(reset=reset)


def start(rec):
    if rec.program.captured is not None:
        _runs(reset=True)


def stop(rec):
    if rec.program.captured is not None:
        runs = _runs()
        if runs is not None:
            rec.notes["ess_check_runs"] = runs


def read(rec):
    if "ess_check_runs" not in rec.notes:
        return None
    return rec.notes["ess_check_runs"] / len(rec.runs)
