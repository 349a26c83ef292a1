"""The port's spans (genparticlefilters_tpu_torch/utils/spans.py) and the
host-read counter of ``host_pred``, on the CPU.

- Without a profiler ``span`` is a null context, adds nothing to a
  capture (a stand-in: the stream reported capturing, the marker library
  reported loaded) and loads nothing; under the profiler on the CPU it is
  a host span and emits no marker; under the profiler inside the stand-in
  capture it launches one marker at entry and one at exit, beside its
  host span.
- ``device_span_totals`` on synthetic logs: nesting and parents, replays
  split by ``captured.run``, ``skip_runs``, each kind of unmatched record
  raising, a log that dropped records giving None.
- ``on_profiler_clock`` on synthetic records: a known offset of the
  profiler's clock, jitter, anchors of replays before the log began, and
  the records of one span name dropped by the profiler.
- ``host_pred.reads`` counts one per host read, none for a predicate it
  passes through to the captured form, and nine for an eager
  object-motion run of ten steps.
"""

import contextlib
import importlib
import random

import pytest
import torch
from torch.profiler import profile, ProfilerActivity, record_function

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.ops import build
from genparticlefilters_tpu_torch.utils import spans
from genparticlefilters_tpu_torch.utils.spans import (
    RUN, DeviceSpans, SpanTotal, device_span_totals, on_profiler_clock, span)

cap = importlib.import_module("genparticlefilters_tpu_torch.smc.capture")


@pytest.fixture
def stand_in_capture(monkeypatch):
    """The stream reported capturing and the marker library reported
    loaded; the markers launched, as ``(tag, name)``, land in the list
    returned."""
    marks = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(spans, "_loaded", lambda: "lib")
    monkeypatch.setattr(spans, "_mark", lambda lib, tag: marks.append(
        (tag, spans._NAMES[tag >> 1])))
    return marks


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


# --- span ---------------------------------------------------------------------

def test_span_without_a_profiler_is_nothing(stand_in_capture):
    ctx = span("om.update")
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx:
        pass
    assert stand_in_capture == []
    assert "span_log" not in build._LOADED


def test_span_under_the_profiler_on_the_cpu_is_a_host_span():
    before = spans._mark.launches
    with _profiled() as prof:
        ctx = span("om.update")
        assert isinstance(ctx, record_function)
        with ctx:
            torch.ones(3).sum()
    assert spans._mark.launches == before
    assert "span_log" not in build._LOADED
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "om.update" in names


def test_span_under_the_profiler_in_a_capture_marks_entry_and_exit(
        stand_in_capture):
    with _profiled() as prof:
        with span(RUN):
            with span("om.ess_check"):
                pass
    tags = [t for t, _ in stand_in_capture]
    names = [n for _, n in stand_in_capture]
    assert names == [RUN, "om.ess_check", "om.ess_check", RUN]
    assert [t & 1 for t in tags] == [0, 0, 1, 1]
    assert tags[0] >> 1 == tags[3] >> 1 != tags[1] >> 1 == tags[2] >> 1
    host = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {RUN, "om.ess_check"} <= host


def test_arm_device_spans_without_a_profiler_or_a_card_loads_nothing():
    assert spans.arm_device_spans() is False
    if not torch.cuda.is_available():
        with _profiled():
            assert spans.arm_device_spans() is False
    assert "span_log" not in build._LOADED
    assert spans.device_spans() is None


# --- device_span_totals -------------------------------------------------------

def _log(entries, dropped=0):
    """A DeviceSpans of ``entries``: ``(name, "b" | "e", ns)``."""
    names = []
    for n, _, _ in entries:
        if n not in names:
            names.append(n)
    ids = torch.tensor([names.index(n) for n, _, _ in entries],
                       dtype=torch.int64)
    ends = torch.tensor([k == "e" for _, k, _ in entries], dtype=torch.bool)
    ns = torch.tensor([t for _, _, t in entries], dtype=torch.int64)
    return DeviceSpans(tuple(names), ids, ends, ns, dropped)


def _replay(t0, taken):
    """One object-motion-like replay from ``t0``: initialize, then per
    step an ESS check, the IF body's resample and rejuvenate where
    ``taken``, and an update; every marker at least 2,500 ns after the
    last (a graph node's latency)."""
    out, t = [], t0

    def mark(name, kind, gap=2500):
        nonlocal t
        t += gap
        out.append((name, kind, t))
    mark(RUN, "b")
    mark("om.initialize", "b")
    mark("om.initialize", "e", 5000)
    for take in taken:
        mark("om.ess_check", "b")
        mark("om.ess_check", "e", 3000)
        if take:
            for name in ("om.resample", "om.rejuvenate"):
                mark(name, "b")
                mark(name, "e", 20000)
        mark("om.update", "b")
        mark("om.update", "e", 40000)
    mark(RUN, "e")
    return out, t


def test_totals_split_replays_and_nest():
    a, t = _replay(0, [True, False, True])
    b, _ = _replay(t + 50_000, [False, False, False])
    runs = device_span_totals(_log(a + b))
    assert len(runs) == 2
    first, second = runs
    assert first["om.resample"] == SpanTotal(2 * 20000, 2, RUN)
    assert first["om.update"] == SpanTotal(3 * 40000, 3, RUN)
    assert first["om.ess_check"].count == 3
    assert first[RUN].parent is None and first[RUN].count == 1
    assert first[RUN].ns == a[-1][2] - a[0][2]
    assert "om.resample" not in second
    assert second["om.update"].count == 3
    assert device_span_totals(_log(a + b), skip_runs=1) == [second]
    assert device_span_totals(_log(a + b), skip_runs=2) == []


def test_totals_give_a_nested_span_its_parent():
    log = _log([(RUN, "b", 0), ("outer", "b", 10), ("inner", "b", 20),
                ("inner", "e", 50), ("outer", "e", 70), (RUN, "e", 90)])
    (run,) = device_span_totals(log)
    assert run["inner"] == SpanTotal(30, 1, "outer")
    assert run["outer"] == SpanTotal(60, 1, RUN)
    assert run[RUN] == SpanTotal(90, 1, None)


@pytest.mark.parametrize("entries,match", [
    ([(RUN, "b", 0), ("om.update", "b", 1)], "never left"),
    ([(RUN, "b", 0), ("om.update", "b", 1), (RUN, "e", 2)], "exits where"),
    ([(RUN, "b", 0), ("om.update", "e", 1), (RUN, "e", 2)], "exits where"),
    ([("om.update", "b", 0), ("om.update", "e", 1)], "outside"),
    ([(RUN, "e", 0)], "no span"),
])
def test_totals_raise_on_an_unmatched_record(entries, match):
    with pytest.raises(ValueError, match=match):
        device_span_totals(_log(entries))


def test_totals_of_a_log_that_dropped_records_are_none():
    a, _ = _replay(0, [True])
    assert device_span_totals(_log(a, dropped=3)) is None
    assert device_span_totals(_log(a, dropped=0)) is not None


# --- on_profiler_clock --------------------------------------------------------

class _Event:
    def __init__(self, name, start):
        self._name, self._start = name, start

    def name(self):
        return self._name

    def start_ns(self):
        return self._start


def test_on_profiler_clock_finds_the_offset_and_the_dropped_records():
    rng = random.Random(7)
    warm, t = [], 0
    for k in range(3):  # replays the profiler saw before the log began
        rec, t = _replay(t + 10_000 + 997 * k, [k % 2 == 0] * 9)
        warm += rec
    entries, t = [], t + 2_000_000
    for k in range(40):
        rec, t = _replay(t + 7_000 + rng.randrange(30_000),
                         [rng.random() < 0.3 for _ in range(9)])
        entries += rec
    log = _log(entries)
    offset = 1_760_000_000_000_000_000 - 123_456_789
    profiled = entries[:len(entries) // 2]  # the profiler stopped midway
    events = [_Event("span_mark_kernel(unsigned int)",
                     t_ + offset + rng.randrange(-200, 201))
              for name, _, t_ in warm + profiled
              if name not in ("om.resample", "om.rejuvenate")]
    events += [_Event("cudaGraphLaunch", 5), _Event("om.update", 9)]
    clock = on_profiler_clock(log, events)
    assert abs(clock.offset_ns - offset) <= 200
    assert clock.residuals_ns.abs().max() <= 400
    assert torch.equal(clock.ns, log.ns + clock.offset_ns)
    inside = {}
    for name, _, _ in profiled:
        inside[name] = inside.get(name, 0) + 1
    assert clock.logged == inside
    assert clock.held == {n: (0 if n in ("om.resample", "om.rejuvenate")
                              else c) for n, c in inside.items()}


def test_on_profiler_clock_without_anchors_is_none():
    a, _ = _replay(0, [True])
    assert on_profiler_clock(_log(a), [_Event("cudaGraphLaunch", 1)]) is None
    assert on_profiler_clock(_log([]), [_Event(spans.MARKER, 1)] * 2) is None


# --- host_pred.reads ----------------------------------------------------------

@pytest.mark.parametrize("pred,reads", [(True, 1), (torch.tensor(False), 1),
                                        (torch.tensor(0.2) < 0.5, 1)])
def test_host_pred_counts_each_host_read(pred, reads):
    before = tg.host_pred.reads
    tg.host_pred(pred)
    assert tg.host_pred.reads - before == reads


def test_host_pred_counts_nothing_it_passes_through(monkeypatch):
    monkeypatch.setattr(cap, "_graph_form", lambda pred: True)
    pred = torch.tensor(True)
    before = tg.host_pred.reads
    assert tg.host_pred(pred) is pred
    assert tg.host_pred.reads == before


def test_host_pred_counts_one_read_per_ess_check_of_an_eager_run():
    from genparticlefilters_tpu_torch.models import object_motion as om
    gen = torch.Generator().manual_seed(3)
    y = torch.linspace(0.0, 1.0, 10)
    before = tg.host_pred.reads
    om.object_motion_filter(gen, y, 64, 10, resample_method="systematic")
    assert tg.host_pred.reads - before == 9
