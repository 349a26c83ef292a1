"""host_ms.ess_check.eager: host ms per run inside the filter's
``*.ess_check`` spans (the ESS computed and read on the host), in the
traced window."""


def read(rec):
    if rec.trace is None or rec.program.captured is not None:
        return None
    return 1e3 * rec.trace.span_s(".ess_check") / rec.trace.runs
