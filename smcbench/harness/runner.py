"""One run of one cell: set-up, the closed-loop window, the metrics and
the check that decides ``correct``.

The traffic is a closed loop with one client: each run filters the next
sequence of the configuration's pool as soon as the run before it has
finished (``torch.cuda.synchronize``), until ``seconds`` have passed. A
run's wall time is the host clock from handing the program its sequence
to that synchronize.

A traced run (``trace=1``) starts ``torch.profiler`` before set-up (a
CUDA graph's kernels are recorded only if the profiler ran at its
capture), keeps it for the window's first ``trace_runs`` runs and records
CUDA events around every run; it reports the per-layer metrics. An
untraced run reports the end-to-end metrics.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time

import torch

from . import stats
from .tracing import TRACED, Trace

#: top-level module names that no run may have loaded once its window
#: has closed: JAX and the JAX package, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "genparticlefilters_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    modules loaded in this process)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Record:
    """What a run hands to the metric readers: the cell, the program,
    the window's runs ``[(start, end)]`` in host seconds, ``setup_s``,
    the traced window (``trace``, a :class:`~.tracing.Trace`, or None),
    the device time of each run from CUDA events (``run_device_s``,
    traced runs only), the count of runs profiled (``traced_runs``) and
    ``notes``, where a metric keeps what it recorded."""

    def __init__(self, cell, device):
        self.cell = cell
        self.device = device
        self.program = None
        self.runs = []
        self.setup_s = None
        self.trace = None
        self.run_device_s = []
        self.traced_runs = 0
        self.notes = {}

    @property
    def work_per_run(self) -> int:
        """Particle updates per run: N · T."""
        return self.cell.traffic["particles"] * self.cell.config["t_max"]


def _profiler():
    from torch.profiler import profile, ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, program=None) -> dict:
    """Run ``cell`` once and return the result line's object (without the
    ``device`` key's card facts, which :func:`device_facts` adds).
    ``t_start`` is the host clock at process start; ``program`` replaces
    the configuration's ``Program`` (the control, and the tests' faults)."""
    device = torch.device(device)
    mod = cell.program()
    make = program or mod.Program
    traffic = cell.traffic
    rec = Record(cell, device)
    metrics = cell.per_layer() if trace else cell.end_to_end()
    readers = {m["name"]: cell.metric(m["name"]) for m in metrics}
    undo, prof = [], None
    if trace:
        undo = [r.prepare(rec) for r in readers.values()
                if hasattr(r, "prepare")]
        prof = _profiler()
        prof.start()
    seqs = mod.pool(cell, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1_000_003)
    prog = make(cell, gen, seqs)
    rec.program = prog
    # every shape and buffer of the window, including the outputs held
    # for the check, met before it starts
    warm = [prog.run(seqs[i % len(seqs)])
            for i in range(traffic["check_runs"] + 2)]
    _sync(device)
    del warm
    for u in undo:
        u()
    gc.collect()
    for r in readers.values():
        if hasattr(r, "start"):
            r.start(rec)
    kept = _window(rec, prog, seqs, seed, seconds, prof, t_start)
    for r in readers.values():
        if hasattr(r, "stop"):
            r.stop(rec)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if prof is not None:
        rec.trace = Trace(prof.profiler.kineto_results.events(),
                          rec.traced_runs)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    answers = [(i, prog.answer(out)) for i, out in kept]
    runs, trace_rec = len(rec.runs), rec.trace
    del kept, prog, rec.program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = judge(cell, answers, seqs)
    result = {"correct": failed == 0, "attempted": runs, "failed": failed,
              "metrics": values,
              "device": {"count": cell.chips, "memory_peak_bytes": peak}}
    if trace_rec is not None:
        result["device"].update(busy_s=trace_rec.busy_s,
                                window_s=trace_rec.window_s)
        result["breakdown"] = {"device_ops": trace_rec.top_ops(),
                               "idle_gaps": trace_rec.idle_gaps()}
    ms = sorted(stats.run_ms(rec.runs))
    result["window"] = {"runs": runs, "median_ms": ms[len(ms) // 2],
                        "min_ms": ms[0], "max_ms": ms[-1],
                        "traced_runs": rec.traced_runs}
    result["checks"] = checks
    return result


def _window(rec, prog, seqs, seed, seconds, prof, t_start):
    """The closed loop. Returns the outputs kept for the check: a sample
    of ``check_runs`` runs drawn from the seed (reservoir sampling), as
    ``[(pool index, output)]``."""
    device, traffic = rec.device, rec.cell.traffic
    k = traffic["check_runs"]
    pick = random.Random(seed)
    kept = []
    events = []
    traced = traffic["trace_runs"] if prof is not None else 0
    marker = None
    i = 0
    _sync(device)
    first = time.perf_counter()
    rec.setup_s = first - t_start
    while True:
        j = i % len(seqs)
        if i == 0 and traced:
            marker = torch.profiler.record_function(TRACED)
            marker.__enter__()
        start = time.perf_counter()
        if prof is not None and device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = prog.run(seqs[j])
            ev[1].record()
            events.append(ev)
        else:
            out = prog.run(seqs[j])
        _sync(device)
        end = time.perf_counter()
        rec.runs.append((start, end))
        if i < k:
            kept.append((j, out))
        else:
            slot = pick.randrange(i + 1)
            if slot < k:
                kept[slot] = (j, out)
        del out
        i += 1
        if marker is not None and i == traced:
            marker.__exit__(None, None, None)
            marker = None
            prof.stop()
            rec.traced_runs = traced
        if end - first >= seconds and marker is None:
            break
    rec.run_device_s = [a.elapsed_time(b) / 1e3 for a, b in events]
    return kept


def judge(cell, answers, seqs):
    """The check: each kept answer judged by the reference against its
    sequence; each number's largest reading over the answers beside its
    limit. Returns ``({name: {"value", "limit"}}, answers failed)``."""
    ref = cell.reference()
    limits = cell.traffic["limits"]
    worst = {name: 0.0 for name in limits}
    failed = 0
    for j, ans in answers:
        got = ref.judge(ans, seqs[j], cell.config, cell.traffic["ess_frac"])
        # a number that is not a number reads as infinitely far off
        got = {n: math.inf if math.isnan(got[n]) else float(got[n])
               for n in limits}
        failed += any(got[n] > lim for n, lim in limits.items())
        for n in limits:
            worst[n] = max(worst[n], got[n])
    return ({n: {"value": worst[n], "limit": limits[n]} for n in limits},
            failed)


def device_facts() -> dict:
    """The card the run used, as the result line names it."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
