"""device_ms.update.graph: device ms per replay inside the filter's
``*.update`` spans (the Extend update verb), read from the card's span log
(``utils/spans.py``): a graph captured under the profiler holds a marker
at each span's entry and exit, and every replay of the window logs them.

The graph cells' span readers share this file's ``start`` and ``stop``:
the log is emptied before the window and read after it, once, into
``rec.notes``; the first ``rec.traced_runs`` replays, which the profiler
may stretch, are left out. Nothing in an eager cell, or where the program
has no device spans."""


def _spans():
    try:
        from genparticlefilters_tpu_torch.utils.spans import (
            device_spans, device_span_totals)
    except ImportError:
        return None
    return device_spans, device_span_totals


def start(rec):
    fns = _spans()
    if (rec.program.captured is not None and fns is not None
            and "device_spans_reset" not in rec.notes):
        fns[0](reset=True)
        rec.notes["device_spans_reset"] = True


def stop(rec):
    if rec.notes.get("device_spans_reset") and "device_spans" not in rec.notes:
        rec.notes["device_spans"] = _spans()[0]()


def runs(rec):
    """Per replay after the profiled ones, ``{name: SpanTotal}``; None
    where the run logged no device span (or the log overflowed)."""
    if "device_span_totals" not in rec.notes:
        log = rec.notes.get("device_spans")
        got = (None if log is None or not len(log.ns)
               else _spans()[1](log, skip_runs=rec.traced_runs))
        rec.notes["device_span_totals"] = got or None
    return rec.notes["device_span_totals"]


def per_run(rec, suffix: str, field: str = "ns"):
    """The mean over the replays of ``field`` (``ns`` or ``count``) summed
    over the spans whose name ends with ``suffix``."""
    got = runs(rec)
    if got is None:
        return None
    return sum(getattr(t, field) for r in got for name, t in r.items()
               if name.endswith(suffix)) / len(got)


def read(rec):
    ns = per_run(rec, ".update")
    return None if ns is None else ns / 1e6
