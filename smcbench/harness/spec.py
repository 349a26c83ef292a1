"""What one cell is made of, found by the names in ``BENCHMARK.json``.

- the cell: the ``workloads`` entry of that name;
- its configuration: ``configs/<config>.json`` (the sizes and the
  guarantees, as ``BENCHMARK.json``'s ``file`` names it) and
  ``configs/<config>.py`` (the pool of observation sequences and the
  entry the window drives);
- its traffic: ``workloads/<traffic>.json`` (the path, particle count,
  resampling method, pool size, runs traced and sampled for the check,
  and the limits of the check);
- its reference: ``reference/<config>.py``;
- its metrics: each ``end_to_end`` and ``per_layer`` entry whose
  ``workloads`` list the cell (an ``end_to_end`` entry without the list
  applies to every cell), read by ``metrics/<metric>.py``.

A later cell, configuration or metric is new files and new entries here;
no file of the harness changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
import zlib
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, kind: str):
    """The module at ``path``, loaded by path (a file name may hold dots),
    once per path."""
    path = Path(path).resolve()
    name = (f"smcbench_{kind}_" + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
            + f"_{zlib.crc32(str(path).encode()):08x}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


class Cell:
    """One ``workloads`` entry of ``BENCHMARK.json`` and the files its
    names lead to. ``bench_dir`` and ``benchmark`` are for tests, which
    lay out a benchmark of their own."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR,
                 benchmark: Path | None = None):
        self.bench_dir = Path(bench_dir)
        path = benchmark or self.bench_dir.parent / "BENCHMARK.json"
        self.benchmark = json.loads(Path(path).read_text())
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {path}; there are "
                           f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.benchmark["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads(
            (self.bench_dir.parent / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.bench_dir / "workloads"
             / f"{self.entry['traffic']}.json").read_text())
        self.chips = int(self.entry["chips"])

    @property
    def config_name(self) -> str:
        return self.entry["config"]

    def program(self):
        """``configs/<config>.py``: the pool and the entry under test."""
        return load_module(self.bench_dir / "configs"
                           / f"{self.config_name}.py", "config")

    def reference(self):
        """``reference/<config>.py``, imported as part of the
        ``smcbench.reference`` package (it shares ``common.py``)."""
        if str(self.bench_dir.parent) not in sys.path:
            sys.path.insert(0, str(self.bench_dir.parent))
        return importlib.import_module(
            f"{self.bench_dir.name}.reference.{self.config_name}")

    def end_to_end(self) -> list:
        """The ``end_to_end`` entries this cell reports."""
        return [m for m in self.benchmark["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The ``per_layer`` entries this cell reports: those whose
        ``workloads`` list it (every entry has the list)."""
        return [m for m in self.benchmark["per_layer"]
                if self.name in m["workloads"]]

    def metric(self, name: str):
        """``metrics/<name>.py``: its ``read(rec)`` returns the value, or
        None where the run left nothing to read; an optional
        ``prepare(rec)``, called before set-up in a traced run, returns
        a function that undoes what it set up."""
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "metric")
