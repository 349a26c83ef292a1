"""resamples_per_run.graph: ``*.resample`` spans logged per replay, that
is the ESS branches taken, counted on the card: the span sits inside the
IF node's body, whose markers run only where its predicate held. Read
from the card's span log as ``device_ms.update.graph`` reads it."""

from pathlib import Path

from smcbench.harness.spec import load_module

_base = load_module(Path(__file__).with_name("device_ms.update.graph.py"),
                    "metric")
start, stop = _base.start, _base.stop


def read(rec):
    return _base.per_run(rec, ".resample", "count")
