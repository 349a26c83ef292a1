"""setup_s: seconds from process start to the first timed run (imports,
the card, the kernels' build or load, the pool, the capture, warm-up)."""


def read(rec):
    return rec.setup_s
