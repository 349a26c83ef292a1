"""copy_leaves_per_run: runs of ``copy_leaves_kernel`` (the copy-back of a
taken ESS branch in a captured graph) per filter run, counted on the card
by the kernel itself over the whole window."""


def _runs(reset=False):
    from genparticlefilters_tpu_torch.ops.graph_cond import copy_leaves_runs
    return copy_leaves_runs(reset=reset)


def start(rec):
    if rec.program.captured is not None:
        _runs(reset=True)


def stop(rec):
    if rec.program.captured is not None:
        rec.notes["copy_leaves_runs"] = _runs()


def read(rec):
    if "copy_leaves_runs" not in rec.notes:
        return None
    return rec.notes["copy_leaves_runs"] / len(rec.runs)
