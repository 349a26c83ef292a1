"""The benchmark's arithmetic and its data-driven layout, on the CPU."""

import json
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from smcbench.harness import stats
from smcbench.harness.runner import forbidden_modules, Record
from smcbench.harness.spec import Cell, BENCH_DIR, ROOT, load_module
from smcbench.harness.tracing import Trace, TRACED

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the contract's characters: names, config/traffic names and ``reduced``
#: keys; units
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# --- the end-to-end arithmetic ---------------------------------------------

def test_rate_is_over_the_whole_window():
    runs = [(0.0, 1.0), (1.5, 2.0), (2.0, 4.0)]
    # 3 runs of 10 updates over the 4 s from the first start to the last end
    assert stats.rate(runs, 10) == pytest.approx(30 / 4)
    assert stats.window_seconds(runs) == 4.0


@pytest.mark.parametrize("name,of", [("run_ms_p95.eager", "run_ms_p95"),
                                     ("run_ms_p95.1m", "run_ms_p95")])
def test_metric_twins_read_as_their_original(name, of):
    rec = Record(Cell("om.100k.graph.sys"), "cpu")
    rec.runs = [(0.0, 0.004), (0.004, 0.0095), (0.01, 0.013)]
    got = load_module(BENCH_DIR / "metrics" / f"{name}.py", "metric")
    want = load_module(BENCH_DIR / "metrics" / f"{of}.py", "metric")
    assert got.read is want.read
    assert got.read(rec) == want.read(rec)


def test_p95_is_over_every_run():
    rng = np.random.default_rng(1)
    times = list(rng.exponential(5.0, size=997))
    runs, t = [], 0.0
    for ms in times:
        runs.append((t, t + ms / 1e3))
        t += ms / 1e3 + 1e-4
    assert stats.p95_ms(runs) == pytest.approx(np.percentile(times, 95),
                                               rel=1e-9)
    assert stats.percentile([3.0], 95) == 3.0


# --- the trace --------------------------------------------------------------

class _Dev:
    def __init__(self, name):
        self.name = name


class _Ev:
    def __init__(self, name, start, dur, device=False, span=False, tid=1):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._span, self._tid = device, span, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return _Dev("CUDA" if self._dev else "CPU")

    def is_user_annotation(self):
        return self._span

    def start_thread_id(self):
        return self._tid


def _trace():
    ev = [_Ev(TRACED, 0, 1000, span=True),
          _Ev("om.update", 100, 300, span=True),
          _Ev("aten::add", 150, 100),
          _Ev("cudaLaunchKernel", 160, 20),
          _Ev("om.update", 100, 300, device=True, span=True),
          _Ev("k1", 200, 100, device=True),
          _Ev("k2", 250, 150, device=True),
          _Ev("k1", 600, 100, device=True),
          _Ev("late", 1500, 10, device=True)]
    return Trace(ev, runs=2)


def test_trace_busy_is_the_union_of_device_ops():
    tr = _trace()
    # [200, 400] and [600, 700]; the span's device record and the op
    # after the window do not count
    assert tr.busy_intervals() == [(200, 400), (600, 700)]
    assert tr.busy_s == pytest.approx(300e-9)
    assert tr.window_s == pytest.approx(1000e-9)
    assert len(tr.device) == 3
    assert tr.span_s(".update") == pytest.approx(300e-9)


def test_trace_top_ops_and_idle_gaps():
    tr = _trace()
    assert tr.top_ops()[0] == ["k1", pytest.approx(200e-9)]
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # [0, 200): the host in om.update / aten::add from 150 on, not at 0
    assert gaps["- / -"] == pytest.approx(200e-9 + 300e-9)
    assert gaps["- / -"] + sum(v for k, v in gaps.items() if k != "- / -") \
        == pytest.approx(700e-9)


def test_trace_labels_innermost_span_and_event():
    tr = _trace()
    assert tr._labels([155, 165, 390]) == [
        "om.update / aten::add", "om.update / cudaLaunchKernel",
        "om.update / -"]


# --- kernels' bytes ---------------------------------------------------------

def test_g1_bytes():
    mod = load_module(BENCH_DIR / "metrics" / "g1_roofline.py", "metric")
    # pieces (1, 1, 1, 40) at N = M = 100K: 43 rows read and written,
    # F read and the parents written, 4 bytes each
    assert mod.g1_bytes((1, 1, 1, 40), 100_000, 100_000) == \
        4 * (43 * 2 + 2) * 100_000
    assert mod.g1_bytes((), 10, 20) == 4 * 30


def test_copy_bytes():
    import torch
    mod = load_module(BENCH_DIR / "metrics" / "copy_leaves_roofline.py",
                      "metric")
    leaves = [((10, 1000), torch.float32), ((10, 1000), torch.bool),
              ((1000,), torch.int32), ((), torch.float32)]
    assert mod.copy_bytes(leaves) == 2 * (40_000 + 10_000 + 4_000 + 4)


# --- BENCHMARK.json against the contract's characters and layout -----------

def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in _metrics()]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in _metrics())
    for group in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got))
    got = [m["name"] for m in _metrics()]
    assert len(got) == len(set(got))
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in _metrics():
        assert m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"], m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_has_its_files_and_metrics():
    for w in BENCH["workloads"]:
        cell = Cell(w["name"])
        assert (BENCH_DIR / "configs" / f"{w['config']}.py").exists()
        assert (BENCH_DIR / "reference" / f"{w['config']}.py").exists()
        t = cell.traffic
        assert t["path"] in ("graph", "eager")
        assert set(t["limits"]) >= {"score_gap", "weight_gap", "lml_gap"}
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert m["moves"] in reported


# --- a new cell, configuration or metric is files alone ---------------------

def test_new_files_are_found_without_edits(tmp_path):
    bench = tmp_path / "smcbench"
    shutil.copytree(BENCH_DIR / "workloads", bench / "workloads")
    shutil.copytree(BENCH_DIR / "configs", bench / "configs")
    (bench / "metrics").mkdir()
    spec = json.loads(json.dumps(BENCH))
    traffic = json.loads((bench / "workloads"
                          / "om.100k.graph.sys.json").read_text())
    traffic["particles"] = 1000
    (bench / "workloads" / "om.1k.tiny.json").write_text(json.dumps(traffic))
    cfg = json.loads((bench / "configs" / "object_motion.json").read_text())
    (bench / "configs" / "object_motion_b.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "configs" / "object_motion.py",
                bench / "configs" / "object_motion_b.py")
    (bench / "metrics" / "runs_seen.py").write_text(textwrap.dedent('''
        """runs_seen: runs in the window."""


        def read(rec):
            return len(rec.runs)
        '''))
    spec["configs"].append({"name": "object_motion_b", "source": "a test",
                            "file": "smcbench/configs/object_motion_b.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "om.1k.tiny", "config":
                              "object_motion_b", "traffic": "om.1k.tiny",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "runs_seen", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "updates_per_s",
                              "workloads": ["om.1k.tiny"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "om.100k.graph.sys" in m["workloads"]:
            m["workloads"].append("om.1k.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = Cell("om.1k.tiny", bench_dir=bench)
    assert cell.traffic["particles"] == 1000
    assert cell.config_name == "object_motion_b"
    assert "runs_seen" in [m["name"] for m in cell.per_layer()]
    assert {"updates_per_s", "setup_s"} <= {m["name"]
                                            for m in cell.end_to_end()}
    rec = Record(cell, "cpu")
    rec.runs = [(0.0, 1.0)] * 3
    assert cell.metric("runs_seen").read(rec) == 3
    seqs = cell.program().pool(cell, 5, "cpu")
    assert tuple(seqs.shape) == (traffic["pool"], cfg["t_max"])


# --- what a run may load ----------------------------------------------------

def test_no_jax_check_compares_whole_top_level_names():
    ok = ["genparticlefilters_tpu_torch", "genparticlefilters_tpu_torch.core",
          "jaxtyping", "flaxen", "smcbench.jax_free"]
    assert forbidden_modules(ok) == []
    assert forbidden_modules(ok + ["jax.numpy"]) == ["jax"]
    assert forbidden_modules(["genparticlefilters_tpu.core.gfi", "jaxlib",
                              "flax"]) == ["flax", "genparticlefilters_tpu",
                                           "jaxlib"]


def test_reference_loads_neither_the_program_nor_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import smcbench.reference.object_motion, "
            "smcbench.reference.stochastic_volatility, "
            "smcbench.reference.control\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'genparticlefilters_tpu', "
            "'genparticlefilters_tpu_torch'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from smcbench.harness.spec import Cell\n"
            "c = Cell('om.100k.graph.sys'); c.program()\n"
            "import genparticlefilters_tpu_torch.models.object_motion, "
            "genparticlefilters_tpu_torch.models.stochastic_volatility\n"
            "from smcbench.harness.runner import forbidden_modules\n"
            "print(forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("layout", ["checkout", "benchmark_only"])
def test_run_prints_no_result_without_a_card_or_program(tmp_path, layout):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = ROOT
    if layout == "benchmark_only":
        shutil.copytree(BENCH_DIR, tmp_path / "smcbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        root = tmp_path
    out = subprocess.run(
        [sys.executable, "smcbench/run.py", "--workload", "om.100k.graph.sys",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
