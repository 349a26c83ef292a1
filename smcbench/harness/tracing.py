"""What a traced run reads from ``torch.profiler``: the device operations
in the traced window, the host spans, and where the device sat idle.

The traced window is the host interval of the harness's ``TRACED``
annotation, around the first ``trace_runs`` runs of the window. Device
operations are the profiler's records on the card that are not span
annotations; in a CUDA graph the profiler drops some records of kernels
inside IF bodies, so busy time there is a lower bound.
"""

from __future__ import annotations

import collections

#: the harness's own annotation around the traced runs
TRACED = "smcbench.traced"


def _is_device(ev) -> bool:
    return ev.device_type().name == "CUDA"


class Trace:
    """The records of one traced window of ``runs`` runs.

    - ``device``: sorted ``(start_ns, end_ns, name)`` of the device
      operations that start inside the window;
    - ``spans``: total host ns per span annotation name in the window;
    - ``host``: ``(start_ns, end_ns, name, is_span)`` of the host events
      of the busiest host thread, by start."""

    def __init__(self, events, runs: int):
        events = list(events)
        marks = [e for e in events if e.name() == TRACED and not _is_device(e)]
        if not marks:
            raise RuntimeError(f"the profile holds no {TRACED!r} span")
        self.t0 = marks[0].start_ns()
        self.t1 = self.t0 + marks[0].duration_ns()
        self.runs = runs
        spans = {e.name() for e in events
                 if e.is_user_annotation() and not _is_device(e)}
        self.device = sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if _is_device(e) and e.name() not in spans
            and self.t0 <= e.start_ns() <= self.t1)
        inside = [e for e in events if not _is_device(e)
                  and self.t0 <= e.start_ns() < self.t1 and e.name() != TRACED]
        self.spans = collections.Counter()
        for e in inside:
            if e.is_user_annotation():
                self.spans[e.name()] += e.duration_ns()
        threads = collections.Counter(e.start_thread_id() for e in inside)
        main = threads.most_common(1)[0][0] if threads else None
        self.host = sorted(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             e.is_user_annotation())
            for e in inside if e.start_thread_id() == main)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint ``(start_ns, end_ns)``."""
        out = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def span_s(self, suffix: str) -> float:
        """Host seconds in spans whose name ends with ``suffix``."""
        return sum(ns for name, ns in self.spans.items()
                   if name.endswith(suffix)) / 1e9

    def top_ops(self, k: int = 10):
        """``[[name, seconds]]`` of the ``k`` device operations that took
        the most time in the window."""
        total = collections.Counter()
        for s, e, name in self.device:
            total[name[:120]] += (e - s) / 1e9
        return [[n, t] for n, t in total.most_common(k)]

    def idle_gaps(self, k: int = 10):
        """``[[what the host was doing, seconds]]``: the device's idle time
        in the window, summed by the host's innermost span and event at
        the start of each gap, the ``k`` largest."""
        busy = self.busy_intervals()
        gaps, edge = [], self.t0
        for s, e in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        total = collections.Counter()
        for (g0, g1), label in zip(gaps, self._labels([g[0] for g in gaps])):
            total[label] += (g1 - g0) / 1e9
        return [[n, t] for n, t in total.most_common(k)]

    def _labels(self, times):
        """For each of the sorted ``times``: ``span / event``, the
        innermost span and the innermost host event open at that time
        (``-`` where none is). One sweep over the host events, which nest
        on one thread."""
        out, stack, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                ev = self.host[i]
                while stack and stack[-1][1] <= ev[0]:
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            span = next((e[2] for e in reversed(stack) if e[3]), "-")
            event = next((e[2] for e in reversed(stack) if not e[3]), "-")
            out.append(f"{span} / {event}"[:120])
        return out
