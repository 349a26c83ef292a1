"""Test configuration: force CPU with 8 virtual devices so sharding tests
run without TPU hardware (the reference's single-process test strategy,
SURVEY.md §4, maps to mesh-on-CPU simulation here)."""

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none "
        "(a test's ``card`` fixture decides)")
