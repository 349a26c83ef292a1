"""host_ms.update.eager: host ms per run inside the filter's ``*.update``
spans (the Extend update verb), in the traced window."""


def read(rec):
    if rec.trace is None or rec.program.captured is not None:
        return None
    return 1e3 * rec.trace.span_s(".update") / rec.trace.runs
