"""The readers of the program's device spans and host-read counter.

On the CPU: the graph cells' span readers on a synthetic log (per-replay
means, the profiled replays left out) and None in an eager cell or where
the program logged nothing; ``host_reads_per_run.eager`` on a traced tiny
eager run (one read per ESS check) and None in a graph cell.

Marked ``chip``, on the card: a graph captured without the profiler holds
no marker node (the graph and its IF bodies walked with
``cudaGraphGetNodes``) and loads no marker library, where one captured
under the profiler holds exactly the markers its spans place and nothing
else more; ``resamples_per_run`` equals, replay for replay, the IF
predicates read after each of 50 single replays in each graph cell (and
``copy_leaves``' own count in the object-motion cells); the new readers
report numbers on a traced run of a graph and of the eager cell.
"""

import importlib
import json
import subprocess
import sys
import time

import pytest
import torch

from smcbench.harness.runner import Record, execute, _profiler
from smcbench.harness.spec import BENCH_DIR, ROOT, Cell, load_module

GRAPH_CELLS = ("om.100k.graph.sys", "om.1m.graph.res", "sv.100k.graph")
SPAN_READERS = ("device_ms.update.graph", "device_ms.resample.graph",
                "device_ms.rejuvenate.graph", "device_ms.ess_check.graph",
                "resamples_per_run.graph")
NEW = SPAN_READERS + ("host_reads_per_run.eager",)


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "metric")


class _Program:
    def __init__(self, captured):
        self.captured = captured


def _synthetic_log():
    """Three replays: one of 2 taken checks, then two of 1 and 0."""
    from genparticlefilters_tpu_torch.utils.spans import RUN, DeviceSpans
    entries, t = [], 0
    for taken in ([True, False, True], [False, True, False],
                  [False, False, False]):
        t += 1000
        entries.append((RUN, 0, t))
        for take in taken:
            entries += [("om.ess_check", 0, t + 10), ("om.ess_check", 1,
                                                      t + 20)]
            t += 20
            if take:
                entries += [("om.resample", 0, t + 10),
                            ("om.resample", 1, t + 310),
                            ("om.rejuvenate", 0, t + 320),
                            ("om.rejuvenate", 1, t + 520)]
                t += 520
            entries += [("om.update", 0, t + 10), ("om.update", 1, t + 1010)]
            t += 1010
        t += 10
        entries.append((RUN, 1, t))
    names = [RUN, "om.ess_check", "om.resample", "om.rejuvenate",
             "om.update"]
    return DeviceSpans(tuple(names),
                       torch.tensor([names.index(n) for n, _, _ in entries]),
                       torch.tensor([bool(e) for _, e, _ in entries]),
                       torch.tensor([x for _, _, x in entries]), 0)


def test_span_readers_read_the_log_per_replay_after_the_profiled_ones():
    rec = Record(Cell("om.100k.graph.sys"), "cpu")
    rec.program = _Program(captured=object())
    rec.runs = [(0.0, 1.0)] * 3
    rec.traced_runs = 1
    rec.notes["device_spans"] = _synthetic_log()
    got = {n: _reader(n).read(rec) for n in SPAN_READERS}
    # replays 2 and 3: 3 updates of 1,000 ns each, checks of 10 ns, one
    # resample of 300 ns and one rejuvenation of 200 ns over the two
    assert got == {"device_ms.update.graph": 3000 / 1e6,
                   "device_ms.resample.graph": 150 / 1e6,
                   "device_ms.rejuvenate.graph": 100 / 1e6,
                   "device_ms.ess_check.graph": 30 / 1e6,
                   "resamples_per_run.graph": 0.5}


@pytest.mark.parametrize("name", NEW)
def test_new_readers_return_none_where_nothing_was_logged(name):
    mod = _reader(name)
    graph = name.endswith(".graph")
    rec = Record(Cell("om.100k.eager.sys" if graph else
                      "om.100k.graph.sys"), "cpu")
    rec.program = _Program(captured=None if graph else object())
    rec.runs = [(0.0, 1.0)] * 2
    mod.start(rec)
    mod.stop(rec)
    assert mod.read(rec) is None
    # a graph program that logged no span (no card, or a program without
    # device spans) reads None too
    rec.program = _Program(captured=object())
    mod.start(rec)
    mod.stop(rec)
    assert mod.read(rec) is None


def test_host_reads_on_a_traced_tiny_eager_run():
    cell = Cell("om.100k.eager.sys")
    cell.traffic.update(particles=2000, check_runs=2, trace_runs=3)
    cell.traffic["limits"] = dict(cell.traffic["limits"], lml_gap=0.5,
                                  posterior_gap=0.2)
    result = execute(cell, 2 ** 31 + 91, 0.5, True, "cpu", time.perf_counter())
    assert result["metrics"]["host_reads_per_run.eager"]["value"] == (
        cell.config["t_max"] - 1)
    assert not set(SPAN_READERS) & set(result["metrics"])


# --- on the card ------------------------------------------------------------

def _counting(fn, found):
    """``fn`` that, at the end of a captured call, counts the nodes of the
    graph under capture and of its IF bodies into ``found``."""
    cap = importlib.import_module("genparticlefilters_tpu_torch.smc.capture")
    from genparticlefilters_tpu_torch.utils.spans import _graph_nodes

    def counted(*args, **kw):
        out = fn(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            found.append(_graph_nodes(
                [g for n in cap._BODIES[-1].nodes for g in n.graphs]))
        return out
    counted.__name__ = fn.__name__
    return counted


_UNTRACED = """
import json, sys, torch
sys.path.insert(0, {root!r})
from genparticlefilters_tpu_torch.models import object_motion as om
from genparticlefilters_tpu_torch.ops import build
gen = torch.Generator(device="cuda").manual_seed(5)
run = om.object_motion_filter_captured(gen, torch.zeros(10, device="cuda"),
                                       10000, 10, resample_method="systematic")
run()
torch.cuda.synchronize()
print(json.dumps({{"loaded": sorted(build._LOADED), "nodes": run.nodes}}))
"""


@pytest.mark.chip
def test_untraced_capture_holds_no_marker(card):
    out = subprocess.run([sys.executable, "-c",
                          _UNTRACED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "span_log" not in got["loaded"] and "graph_cond" in got["loaded"]
    assert got["nodes"] == 9
    from genparticlefilters_tpu_torch.models import object_motion as om
    from genparticlefilters_tpu_torch.smc.capture import capture
    from genparticlefilters_tpu_torch.utils import spans
    # the walk's library, loaded and initialised before the captures
    assert spans._lib().span_log_ready() == 0
    found = {}
    for traced in (False, True):
        counts = []
        fn = _counting(om.object_motion_filter_impl, counts)
        gen = torch.Generator(device=card).manual_seed(5)
        prof = _profiler() if traced else None
        if prof is not None:
            prof.start()
        try:
            capture(fn, gen, torch.zeros(10, device=card), 10000, 10,
                    resample_method="systematic")
        finally:
            if prof is not None:
                prof.stop()
        found[traced] = counts[-1]
    off, on = found[False], found[True]
    assert off["markers"] == 0 and off["conditionals"] == 9, off
    # counted before the run span's exit: its entry, the initialize span,
    # 9 ESS checks and updates in the graph, and in each of the 9 IF
    # bodies a resample and a rejuvenate span
    assert on["markers"] == 1 + 2 + 9 * 4 + 9 * 4, on
    assert on["nodes"] - off["nodes"] == on["markers"], (on, off)
    assert on["kernels"] - off["kernels"] == on["markers"], (on, off)
    assert on["conditionals"] == 9


@pytest.mark.chip
@pytest.mark.parametrize("name", GRAPH_CELLS)
def test_resamples_per_run_match_the_if_predicates(card, name):
    from genparticlefilters_tpu_torch.ops.graph_cond import copy_leaves_runs
    from genparticlefilters_tpu_torch.utils.spans import (
        device_spans, device_span_totals)
    cell = Cell(name)
    mod = cell.program()
    seqs = mod.pool(cell, 2 ** 31 + 4242, card)
    gen = torch.Generator(device=card).manual_seed(2 ** 31 + 11)
    prof = _profiler()
    prof.start()
    try:
        prog = mod.Program(cell, gen, seqs)
    finally:
        prof.stop()
    nodes = prog.captured.bodies.nodes
    prog.run(seqs[0])
    device_spans(reset=True)
    copy_leaves_runs(reset=True)
    preds = []
    for i in range(50):
        prog.run(seqs[i % len(seqs)])
        torch.cuda.synchronize()
        preds.append(sum(bool(n.pred) for n in nodes))
    copies = copy_leaves_runs()
    runs = device_span_totals(device_spans())
    counted = [sum(t.count for k, t in r.items() if k.endswith(".resample"))
               for r in runs]
    assert counted == preds
    assert 0 < sum(preds) < 50 * len(nodes)
    if name.startswith("om."):
        assert copies == sum(preds)


@pytest.mark.chip
@pytest.mark.parametrize("name", ["om.100k.graph.sys", "om.100k.eager.sys"])
def test_new_readers_report_on_a_traced_run(card, name):
    result = execute(Cell(name), 2 ** 31 + 313, 3.0, True, card,
                     time.perf_counter())
    assert result["correct"], result["checks"]
    got = set(result["metrics"])
    if name == "om.100k.eager.sys":
        assert result["metrics"]["host_reads_per_run.eager"]["value"] == 9
        assert not got & set(SPAN_READERS)
    else:
        assert set(SPAN_READERS) <= got and (
            "host_reads_per_run.eager" not in got)
        assert result["metrics"]["device_ms.update.graph"]["value"] > 0
