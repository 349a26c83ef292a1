"""Named spans for the phases of a filter run, on the host and, inside a
captured CUDA graph, on the card.

:func:`span` is the one span. While no profiler runs it is nothing. While
one runs it is a ``torch.profiler`` ``record_function``, a host span; and
where a graph is being captured (by ``smc/capture.py`` ``capture``, which
loads the marker library first) it also adds two nodes to the graph, one
launch of a one-thread marker kernel (``csrc/span_log.cu``) at its entry
and one at its exit. At every replay each marker appends a record to a
log on the card: the span's id, entry or exit, and the card's
``%globaltimer`` in ns. So a span inside an IF node's body records only
where the branch is taken, and the markers stay in the graph after the
profiler stops: an operator who captures under the profiler gets phase
times of every later replay, with no CUPTI.

- :func:`device_spans` reads the log (one synchronize);
- :func:`device_span_totals` matches its entries and exits into each
  replay's device ns and count per span name (``capture`` wraps every
  captured run in a :data:`RUN` span, which delimits the replays);
- :func:`on_profiler_clock` puts the log on the profiler's clock, with
  the profiler's own records of the marker kernels as anchors, and counts
  which of them the profiler dropped.

The log holds 2^20 records of 16 bytes (16 MiB on the card, ~2.4 times
what a 30-s window of the SV cell writes); records past it are counted as
dropped, and a log that dropped any gives no totals.
"""

from __future__ import annotations

import contextlib
import ctypes
import statistics
from typing import NamedTuple

import torch
from torch.profiler import record_function

__all__ = ["span", "RUN", "MARKER", "DeviceSpans", "SpanTotal",
           "ProfilerClock", "arm_device_spans", "device_spans",
           "device_span_totals", "on_profiler_clock"]

#: the span ``capture`` opens around each captured run
RUN = "captured.run"
#: the marker kernel's name, as the profiler records it
MARKER = "span_mark_kernel"
# on_profiler_clock: the farthest a marker's profiler start may lie from
# its logged time (markers lie >= 1.4 us apart on the H100), and the log's
# records that the offset is first fitted to
_TOL_NS = 1000
_PROBE = 512

_LIB = "span_log"
# span name <-> id, the host's half of the log
_NAMES: list = []
_IDS: dict = {}


def _bind(lib):
    lib.span_log_error.argtypes = [ctypes.c_int]
    lib.span_log_error.restype = ctypes.c_char_p
    lib.span_log_capacity.argtypes = []
    lib.span_log_capacity.restype = ctypes.c_ulonglong
    lib.span_log_ready.argtypes = []
    lib.span_log_ready.restype = ctypes.c_int
    lib.span_log_mark.argtypes = [ctypes.c_uint, ctypes.c_void_p]
    lib.span_log_mark.restype = ctypes.c_int
    lib.span_log_count.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.span_log_count.restype = ctypes.c_int
    lib.span_log_copy.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    lib.span_log_copy.restype = ctypes.c_int
    lib.span_log_reset.argtypes = []
    lib.span_log_reset.restype = ctypes.c_int
    lib.span_log_graph_nodes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_void_p]
    lib.span_log_graph_nodes.restype = ctypes.c_int


def _lib():
    from ..ops.build import load_library
    return load_library(_LIB, _bind)


def _loaded():
    """The marker library where it is loaded, else None."""
    from ..ops.build import _LOADED
    return _LOADED[_LIB][0] if _LIB in _LOADED else None


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"span_log: {what} failed: "
                           f"{lib.span_log_error(err).decode()} ({err})")


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def arm_device_spans() -> bool:
    """Whether a capture starting now records device markers: a profiler
    runs and there is a card. If so the marker library is built and its
    module loaded now, outside the capture. ``capture`` calls this before
    it starts timing."""
    if not (_profiling() and torch.cuda.is_available()):
        return False
    lib = _lib()
    _check(lib, lib.span_log_ready(), "loading the marker module")
    return True


def _id(name: str) -> int:
    if name not in _IDS:
        _IDS[name] = len(_NAMES)
        _NAMES.append(name)
    return _IDS[name]


def _mark(lib, tag: int):
    from ..ops.build import launch_on
    device = torch.device("cuda", torch.cuda.current_device())
    _check(lib, launch_on(device, lib.span_log_mark, tag), MARKER)
    _mark.launches += 1


#: marker kernels launched (under a capture: marker nodes captured)
_mark.launches = 0


@contextlib.contextmanager
def _device_span(lib, name: str):
    tag = _id(name) << 1
    with record_function(name):
        _mark(lib, tag)
        yield
        _mark(lib, tag | 1)


def span(name):
    """A named span while a profiler runs, else nothing: an unprofiled
    ``record_function`` costs ~15 µs of host time per span on a slow host,
    the guard under 1 µs. Profiled, it is a ``record_function``; inside a
    graph being captured with the marker library loaded
    (:func:`arm_device_spans`), it also records on the card at every
    replay (see the module docstring)."""
    if not _profiling():
        return contextlib.nullcontext()
    if torch.cuda.is_initialized() and (
            torch.cuda.is_current_stream_capturing()):
        lib = _loaded()
        if lib is not None:
            return _device_span(lib, name)
    return record_function(name)


class DeviceSpans(NamedTuple):
    """The card's span log on the host, one entry per record in the order
    the card wrote them: ``ids`` (int64, into ``names``), ``ends`` (bool:
    the span's exit), ``ns`` (int64, ``%globaltimer``), and ``dropped``,
    the records past the log's capacity."""
    names: tuple
    ids: torch.Tensor
    ends: torch.Tensor
    ns: torch.Tensor
    dropped: int


def device_spans(reset: bool = False) -> DeviceSpans | None:
    """The records of the card's span log since its last reset, as host
    tensors (one synchronize); ``reset=True`` then empties the log. None
    where no capture of this process armed the markers
    (:func:`arm_device_spans`): the library was never loaded."""
    lib = _loaded()
    if lib is None:
        return None
    torch.cuda.synchronize()
    count = ctypes.c_ulonglong(0)
    _check(lib, lib.span_log_count(ctypes.byref(count)), "reading the count")
    n = min(count.value, lib.span_log_capacity())
    raw = torch.empty((n, 2), dtype=torch.int64)
    _check(lib, lib.span_log_copy(raw.data_ptr(), n), "reading the log")
    if reset:
        _check(lib, lib.span_log_reset(), "resetting the log")
    tags = raw[:, 0] & 0xFFFFFFFF
    return DeviceSpans(tuple(_NAMES), tags >> 1, (tags & 1).bool(),
                       raw[:, 1].clone(), count.value - n)


class SpanTotal(NamedTuple):
    """One span name in one replay: device ns summed over its entries and
    exits, how many times it ran, and the span open at its first entry
    (None for :data:`RUN`)."""
    ns: int
    count: int
    parent: str | None


def device_span_totals(records: DeviceSpans, skip_runs: int = 0):
    """Per replay after the first ``skip_runs``, ``{name: SpanTotal}``
    from the log's matched entries and exits; a replay is one :data:`RUN`
    span, and a span's parent is the span open at its entry (the stream
    orders the markers). None where the log dropped records; raises
    ``ValueError`` on an exit that does not close the innermost open span,
    a span outside a :data:`RUN`, or a span left open."""
    if records.dropped:
        return None
    names = records.names
    runs, stack, cur = [], [], None
    for i, end, t in zip(records.ids.tolist(), records.ends.tolist(),
                         records.ns.tolist()):
        name = names[i]
        if not end:
            if not stack:
                if name != RUN:
                    raise ValueError(f"span_log: {name!r} entered outside "
                                     f"any {RUN!r} span")
                cur = {}
            stack.append((name, t))
            continue
        if not stack or stack[-1][0] != name:
            raise ValueError(
                f"span_log: {name!r} exits where "
                f"{stack[-1][0] if stack else 'no span'!r} is open")
        _, t0 = stack.pop()
        old = cur.get(name)
        cur[name] = (SpanTotal(t - t0, 1, stack[-1][0] if stack else None)
                     if old is None else
                     SpanTotal(old.ns + t - t0, old.count + 1, old.parent))
        if not stack:
            runs.append(cur)
    if stack:
        raise ValueError(f"span_log: {stack[-1][0]!r} entered and never "
                         f"left")
    return runs[skip_runs:]


class ProfilerClock(NamedTuple):
    """:func:`on_profiler_clock`'s answer: ``offset_ns`` (profiler ns =
    log ns + offset), ``ns`` (the log's times on the profiler's clock),
    ``residuals_ns`` (each anchored record's profiler start less its
    converted time), ``held`` and ``logged`` (per span name, the records
    in the profiled interval that the profiler holds, and all of them)."""
    offset_ns: int
    ns: torch.Tensor
    residuals_ns: torch.Tensor
    held: dict
    logged: dict


def _nearest(sorted_t: torch.Tensor, t: torch.Tensor):
    """For each of ``t``, the index of the nearest of ``sorted_t`` and the
    signed distance to it (``sorted_t`` minus ``t``)."""
    i = torch.searchsorted(sorted_t, t).clamp_(1, len(sorted_t) - 1)
    lo, hi = sorted_t[i - 1] - t, sorted_t[i] - t
    up = hi.abs() < lo.abs()
    return torch.where(up, i, i - 1), torch.where(up, hi, lo)


def _matches(anchors, t):
    """The residuals of ``t`` against their nearest anchors, and which of
    ``t`` hold an anchor: within :data:`_TOL_NS` and the nearest of all
    ``t`` to that anchor (one record per anchor)."""
    idx, res = _nearest(anchors, t)
    best = torch.full((len(anchors),), torch.iinfo(torch.int64).max,
                      dtype=torch.int64).scatter_reduce_(
                          0, idx, res.abs(), "amin")
    return res, (res.abs() <= _TOL_NS) & (res.abs() == best[idx])


def on_profiler_clock(records: DeviceSpans, events):
    """The log on the profiler's clock. ``events`` are the profiler's
    records (``prof.profiler.kineto_results.events()``: objects with
    ``name()`` and ``start_ns()``); those of the marker kernel
    (:data:`MARKER`) are the anchors. A record holds an anchor where it
    is the nearest record to it and within 1 µs. The offset is the
    median of (anchor start − logged time) over those records, found
    first by trying each anchor against the log's first records and
    keeping the offset that matches the most of its first 512 records (a replay repeats its pattern, but at a wrong offset the
    replays' differing lengths break the line-up). Returns a
    :class:`ProfilerClock`, or None where the log or the profile holds
    no marker."""
    anchors = sorted(e.start_ns() for e in events if MARKER in e.name())
    if len(anchors) < 2 or len(records.ns) == 0:
        return None
    anchors = torch.tensor(anchors, dtype=torch.int64)
    ns = records.ns
    cands = (anchors[:, None] - ns[None, :4]).reshape(-1)
    offset = int(cands[int(_scores(anchors, ns[:_PROBE], cands).argmax())])
    res, hit = _matches(anchors, ns + offset)
    offset += int(statistics.median_low(res[hit].tolist()))
    res, hit = _matches(anchors, ns + offset)
    inside = ((ns + offset >= anchors[0] - _TOL_NS)
              & (ns + offset <= anchors[-1] + _TOL_NS))
    held, logged = {}, {}
    for i, name in enumerate(records.names):
        mine = (records.ids == i) & inside
        if mine.any():
            logged[name] = int(mine.sum())
            held[name] = int((mine & hit).sum())
    return ProfilerClock(offset, ns + offset, res[hit], held, logged)


def _scores(anchors, head, cands):
    """How many of ``head`` each candidate offset puts within
    :data:`_TOL_NS` of an anchor, in chunks of candidates."""
    out = []
    for c in cands.split(256):
        t = (head[None, :] + c[:, None]).reshape(-1)
        out.append((_nearest(anchors, t)[1].abs() <= _TOL_NS)
                   .reshape(len(c), -1).sum(1))
    return torch.cat(out)


def _graph_nodes(bodies=()) -> dict:
    """``{"nodes", "kernels", "markers", "conditionals"}`` of the graph
    the current stream is capturing and of the body graphs ``bodies``
    (raw handles, as ``smc/capture.py`` ``_CardNode.graphs``), child
    graphs included; loads the marker library (the check that a capture
    holds no marker node)."""
    from ..ops.build import launch_on
    lib = _lib()
    bodies = list(bodies)
    handles = (ctypes.c_void_p * max(len(bodies), 1))(*bodies)
    counts = (ctypes.c_longlong * 4)()
    device = torch.device("cuda", torch.cuda.current_device())
    _check(lib, launch_on(device, lib.span_log_graph_nodes,
                          ctypes.cast(handles, ctypes.c_void_p), len(bodies),
                          ctypes.cast(counts, ctypes.c_void_p)),
           "walking the graph")
    return dict(zip(("nodes", "kernels", "markers", "conditionals"), counts))
