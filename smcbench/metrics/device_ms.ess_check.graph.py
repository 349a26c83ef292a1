"""device_ms.ess_check.graph: device ms per replay inside the filter's
``*.ess_check`` spans: the ESS computed and compared on the card (the IF
node that reads the predicate lies outside the span). Read from the
card's span log as ``device_ms.update.graph`` reads it."""

from pathlib import Path

from smcbench.harness.spec import load_module

_base = load_module(Path(__file__).with_name("device_ms.update.graph.py"),
                    "metric")
start, stop = _base.start, _base.stop


def read(rec):
    ns = _base.per_run(rec, ".ess_check")
    return None if ns is None else ns / 1e6
