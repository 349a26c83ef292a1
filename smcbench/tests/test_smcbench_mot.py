"""The multi-object tracking cell (``mot.1m.graph``): its files found by
``Cell``, its pool, its reference's exact posterior, and the check that
decides ``correct`` catching faults planted in the port's config-5 driver.

Faults (planted in ``smc/algorithms.py``'s names before the cell is set up,
so a captured graph holds them):

- ``weights_kept_at_resize``: a resize keeps each parent's log weight
  instead of resetting the weights (the LML then counts them twice);
- ``resize_without_fold``: a resize drops the LML fold of the weights it
  resets;
- ``skipped_resample``: the resampler returns its state unchanged;
- ``growth_skipped``: a resize to more particles returns the state as it
  was (the final count is not the schedule's);
- ``shifted_parents``: the resampler's parents returned one place out of
  line.

On the CPU the cell runs eagerly at a tiny size (N=20,000, K=1, the schedule
scaled to it), where Monte Carlo error is small enough for the LML faults
to show, with the statistical limits widened to that size and the exact
limits as the cell states them. Marked ``chip``, the sound program, the
bfloat16 control and every fault run at the cell's own size and path on
the card, under the cell's own limits; each run's readings are printed as
one JSON line (``python -m pytest smcbench/tests/test_smcbench_mot.py -s``).
There the faults that an exact number catches must come out not correct;
the two LML faults move the LML by about 8 nats, inside the Monte Carlo
tail that ``lml_gap``'s limit leaves at 1M, and are only printed.
"""

import json
import math
import time

import numpy as np
import pytest
import torch

from smcbench.harness.runner import execute
from smcbench.harness.spec import Cell

NAME = "mot.1m.graph"
ALGORITHMS = "genparticlefilters_tpu_torch.smc.algorithms"
FAULTS = ("weights_kept_at_resize", "resize_without_fold", "skipped_resample",
          "growth_skipped", "shifted_parents")
#: the number that must read above its limit under each fault (at the
#: tiny size: at 1M the LML's Monte Carlo tail hides the two LML faults)
CAUGHT_BY = {"weights_kept_at_resize": "lml_gap",
             "resize_without_fold": "lml_gap",
             "skipped_resample": "ess_violations",
             "growth_skipped": "count_bad",
             "shifted_parents": "sibling_mismatch"}
#: the faults an exact number catches, at any size
EXACT_CAUGHT = ("skipped_resample", "growth_skipped", "shifted_parents")
#: the CPU stand-in: tiny, eager, one object, Monte Carlo limits of that
#: size
TINY_N = 20000
TINY_MC = {"lml_gap": 0.6, "posterior_gap": 0.3}


def _plant(monkeypatch, fault):
    import importlib
    alg = importlib.import_module(ALGORITHMS)
    resize, resample = alg.pf_resize, alg.pf_resample

    def resized(change):
        def fn(gen, state, n_new, method, **kw):
            return change(state, resize(gen, state, n_new, method, **kw))
        return fn
    if fault == "weights_kept_at_resize":
        new = resized(lambda s, out: out.replace(
            log_weights=s.log_weights[out.parents.long()]))
        monkeypatch.setattr(alg, "pf_resize", new)
    elif fault == "resize_without_fold":
        new = resized(lambda s, out: out.replace(log_ml_est=s.log_ml_est))
        monkeypatch.setattr(alg, "pf_resize", new)
    elif fault == "growth_skipped":
        def fn(gen, state, n_new, method, **kw):
            if n_new > state.n_particles:
                return state
            return resize(gen, state, n_new, method, **kw)
        monkeypatch.setattr(alg, "pf_resize", fn)
    elif fault == "skipped_resample":
        monkeypatch.setattr(alg, "pf_resample", lambda g, s, *a, **k: s)
    elif fault == "shifted_parents":
        def fn(*a, **k):
            out = resample(*a, **k)
            return out.replace(parents=torch.roll(out.parents, 1))
        monkeypatch.setattr(alg, "pf_resample", fn)
    else:
        raise ValueError(fault)


def _tiny():
    cell = Cell(NAME)
    cell.config["n_objects"] = 1
    for e in cell.config["resize_schedule"]:
        e["particles"] = e["particles"] * TINY_N // cell.traffic["particles"]
    cell.traffic.update(particles=TINY_N, path="eager", check_runs=2, pool=8)
    cell.traffic["limits"] = dict(cell.traffic["limits"], **TINY_MC)
    return cell


def _run(cell, device, seconds=0.5, program=None):
    return execute(cell, 2 ** 31 + 77, seconds, False, device,
                   time.perf_counter(), program=program)


def test_the_cells_files_are_found():
    cell = Cell(NAME)
    assert cell.config_name == "multi_object_tracking" and cell.chips == 1
    assert cell.traffic["path"] == "graph"
    assert cell.traffic["particles"] == 1_000_000
    assert cell.config["t_max"] == 10 and cell.config["n_objects"] == 4
    assert [(e["before_step"], e["particles"], e["method"])
            for e in cell.config["resize_schedule"]] == [
        (3, 500_000, "residual"), (6, 1_000_000, "multinomial")]
    mod, ref = cell.program(), cell.reference()
    assert callable(mod.pool) and hasattr(mod, "Program")
    for fn in ("judge", "exact", "exact_lml", "reference_filter"):
        assert callable(getattr(ref, fn))
    assert {m["name"] for m in cell.end_to_end()} == {
        "updates_per_s", "run_ms_p95", "setup_s"}
    layer = {m["name"] for m in cell.per_layer()}
    assert "device_ms.resize.graph" in layer
    assert "device_ms.rejuvenate.graph" not in layer
    for name in layer:
        assert hasattr(cell.metric(name), "read")
    # every limit is a number the reference's judge returns
    y = mod.pool(cell, 5, "cpu")[0]
    ans = ref.reference_filter(torch.Generator().manual_seed(1), y, 64,
                               dict(cell.config, resize_schedule=[]), 0.5,
                               "systematic", torch.float32)
    assert set(cell.traffic["limits"]) <= set(
        ref.judge(ans, y, cell.config, 0.5, {}))


def test_the_pool_is_drawn_from_the_seed():
    cell = Cell(NAME)
    mod = cell.program()
    a, b = mod.pool(cell, 2 ** 31 + 5, "cpu"), mod.pool(cell, 2 ** 31 + 5,
                                                        "cpu")
    assert a.shape == (64, 10, 4, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, mod.pool(cell, 2 ** 31 + 6, "cpu"))


def test_exact_is_each_coordinates_gaussian():
    from scipy.stats import multivariate_normal
    cell = Cell(NAME)
    p, ref = cell.config, cell.reference()
    y = np.random.default_rng(3).normal(size=(10, 4, 2)) * 2.0
    t = np.arange(10)
    cov = (p["s0"] ** 2 + p["q"] ** 2 * np.minimum(t[:, None], t[None, :]))
    both = cov + p["r"] ** 2 * np.eye(10)
    mean, lml = ref.exact(y, p)
    want = sum(multivariate_normal(np.zeros(10), both).logpdf(y[:, k, d])
               for k in range(4) for d in range(2))
    assert lml == pytest.approx(want, abs=1e-9)
    # E[x_{T-1} | y] by conditioning the joint Gaussian
    gain = cov[-1] @ np.linalg.inv(both)
    for k in range(4):
        for d in range(2):
            assert mean[-1, k, d] == pytest.approx(gain @ y[:, k, d],
                                                   abs=1e-9)


def test_the_judge_reads_a_sound_reference_run_as_sound():
    cell = _tiny()
    ref = cell.reference()
    y = cell.program().pool(cell, 9, "cpu")[0]
    got = ref.judge(ref.reference_filter(
        torch.Generator().manual_seed(2), y, TINY_N, cell.config, 0.5,
        "systematic", torch.float32), y, cell.config, 0.5)
    assert all(got[k] <= v for k, v in cell.traffic["limits"].items()), got


def test_sound_program_passes_at_tiny_size():
    result = _run(_tiny(), "cpu")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_comes_out_not_correct(fault, monkeypatch):
    cell = _tiny()
    _plant(monkeypatch, fault)
    result = _run(cell, "cpu")
    assert not result["correct"], result["checks"]
    got = result["checks"][CAUGHT_BY[fault]]
    assert got["value"] > got["limit"], got


def test_control_fails_and_float32_reference_passes():
    from smcbench.reference.control import Control
    cell = _tiny()
    sound = _run(cell, "cpu",
                 program=lambda c, g, s: Control(c, g, s, torch.float32))
    assert sound["correct"], sound["checks"]
    control = _run(cell, "cpu",
                   program=lambda c, g, s: Control(c, g, s, torch.bfloat16))
    assert not control["correct"], control["checks"]


# --- on the card, at the cell's own size and path ---------------------------

def _reading(kind, result):
    print(json.dumps({"reading": kind, "correct": result["correct"],
                      "checks": {k: v["value"]
                                 for k, v in result["checks"].items()}}),
          flush=True)


@pytest.mark.chip
def test_on_card_sound_passes_faults_and_control_fail(card, monkeypatch):
    from smcbench.reference.control import Control
    sound = _run(Cell(NAME), card, 2.0)
    _reading("sound", sound)
    assert sound["correct"], sound["checks"]
    control = _run(Cell(NAME), card, 2.0,
                   program=lambda c, g, s: Control(c, g, s, torch.bfloat16))
    _reading("control", control)
    assert not control["correct"], control["checks"]
    caught = {}
    for fault in FAULTS:
        with monkeypatch.context() as mp:
            _plant(mp, fault)
            result = _run(Cell(NAME), card, 1.0)
        _reading(fault, result)
        got = result["checks"][CAUGHT_BY[fault]]
        caught[fault] = (not result["correct"]
                         and got["value"] > got["limit"])
    assert all(caught[f] for f in EXACT_CAUGHT), caught
    assert math.isfinite(sound["checks"]["lml_gap"]["value"])
