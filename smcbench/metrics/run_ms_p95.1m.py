"""run_ms_p95.1m: the 95th percentile of every run's wall time in the
window, ms, in a captured cell of 1M particles, bound by the card's
bandwidth; read as ``run_ms_p95``."""

from pathlib import Path

from smcbench.harness.spec import load_module

read = load_module(Path(__file__).with_name("run_ms_p95.py"), "metric").read
