"""device_ms.resample.graph: device ms per replay inside the filter's
``*.resample`` spans: the resample verb (at 1M the guarded scans, G2 count
and G1), inside the ESS branch's IF body, so only where it fired. Read
from the card's span log as ``device_ms.update.graph`` reads it."""

from pathlib import Path

from smcbench.harness.spec import load_module

_base = load_module(Path(__file__).with_name("device_ms.update.graph.py"),
                    "metric")
start, stop = _base.start, _base.stop


def read(rec):
    ns = _base.per_run(rec, ".resample")
    return None if ns is None else ns / 1e6
