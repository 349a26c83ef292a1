"""host_reads_per_run.eager: host reads of an ESS predicate per run
(``host_pred.reads`` over the window ÷ runs), each a synchronize that
waits for the queue; none in a captured replay. Nothing where the program
has no such counter."""


def _reads():
    try:
        from genparticlefilters_tpu_torch.smc.capture import host_pred
    except ImportError:
        return None
    return getattr(host_pred, "reads", None)


def start(rec):
    reads = _reads()
    if rec.program.captured is None and reads is not None:
        rec.notes["host_reads_start"] = reads


def stop(rec):
    if "host_reads_start" in rec.notes:
        rec.notes["host_reads"] = _reads() - rec.notes["host_reads_start"]


def read(rec):
    if "host_reads" not in rec.notes:
        return None
    return rec.notes["host_reads"] / len(rec.runs)
