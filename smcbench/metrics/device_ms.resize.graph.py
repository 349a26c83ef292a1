"""device_ms.resize.graph: device ms per replay inside the filter's
``*.resize`` spans: the online resizes of the schedule (the residual
resize's G2 count and G1 with ``n_out`` ≠ N, the multinomial resize's G2
over brackets with data). Read from the card's span log as
``device_ms.update.graph`` reads it; nothing where the program has no
such span."""

from pathlib import Path

from smcbench.harness.spec import load_module

_base = load_module(Path(__file__).with_name("device_ms.update.graph.py"),
                    "metric")
start, stop = _base.start, _base.stop


def read(rec):
    got = _base.runs(rec)
    if got is None or not any(name.endswith(".resize")
                              for r in got for name in r):
        return None
    return _base.per_run(rec, ".resize") / 1e6
