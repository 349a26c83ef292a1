"""capture_s: host seconds of the filter's CUDA-graph capture
(``CapturedRun.capture_seconds``); nothing in an eager cell."""


def read(rec):
    return rec.program.capture_seconds
