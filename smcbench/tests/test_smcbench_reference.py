"""The plain references against the program at a tiny size, on the CPU;
the control (the reference filter in bfloat16) fails the check; the
reference filter in float32 passes it."""

import json

import numpy as np
import pytest
import torch

from smcbench.harness.spec import BENCH_DIR
from smcbench.reference import object_motion as rom
from smcbench.reference import stochastic_volatility as rsv

OM = json.loads((BENCH_DIR / "configs" / "object_motion.json").read_text())
SV = json.loads((BENCH_DIR / "configs" / "stochastic_volatility.json")
                .read_text())
EXACT = ("score_gap", "weight_gap", "sibling_mismatch", "move_deficit",
         "ess_violations", "parents_bad")


def _limits(cell):
    return json.loads((BENCH_DIR / "workloads" / f"{cell}.json")
                      .read_text())["limits"]


def _answer(state, names):
    import genparticlefilters_tpu_torch as g
    ch = state.traces.get_choices()
    return {"latents": {k: ch[(k,)] for k in names},
            "log_weights": state.log_weights,
            "lml": g.log_ml_estimate(state), "parents": state.parents,
            "score": state.traces.score}



def test_exact_matches_the_programs_enumeration():
    from genparticlefilters_tpu_torch.models.object_motion import (
        exact_posterior)
    y = np.random.default_rng(3).normal(size=OM["t_max"]).cumsum() * 0.3
    post, lml = rom.exact(y, OM)
    want_post, want_lml = exact_posterior(y)
    np.testing.assert_allclose(post, want_post, rtol=0, atol=1e-12)
    assert lml == pytest.approx(want_lml, abs=1e-10)


def test_grid_has_converged():
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(60, generator=gen) * 0.6
    a = rsv.grid(y, SV)
    b = rsv.grid(y, SV, points=2 * rsv.GRID_POINTS)
    assert a[0] == pytest.approx(b[0], abs=1e-8)
    assert a[1] == pytest.approx(b[1], abs=1e-8)


@pytest.mark.parametrize("method,cell", [("systematic", "om.100k.graph.sys"),
                                         ("residual", "om.1m.graph.res")])
def test_program_passes_the_object_motion_check(method, cell):
    from genparticlefilters_tpu_torch.models.object_motion import (
        object_motion_filter, synthesize_data)
    limits = _limits(cell)
    for seed in range(2):
        gen = torch.Generator().manual_seed(seed)
        y, _ = synthesize_data(gen, OM["t_max"], 3 + 2 * seed)
        st = object_motion_filter(gen, y, 2000, OM["t_max"], 0.5, method)
        got = rom.judge(_answer(st, ("moving", "y")), y, OM, 0.5)
        for k in EXACT:
            assert got[k] <= limits[k], (k, got)
        # Monte Carlo error at N = 2000
        assert got["lml_gap"] < 0.3 and got["posterior_gap"] < 0.15, got


def test_program_passes_the_sv_check():
    from genparticlefilters_tpu_torch.models.stochastic_volatility import (
        SVParams, sv_particle_filter, synthesize_sv_data)
    p = SVParams(SV["mu"], SV["phi"], SV["sigma"])
    limits = _limits("sv.100k.graph")
    gen = torch.Generator().manual_seed(11)
    y = synthesize_sv_data(gen, 40, p)
    st = sv_particle_filter(gen, y, 2000, 40, p, 0.5, 1, 2)
    got = rsv.judge(_answer(st, ("h",)), y, SV, 0.5)
    for k in EXACT:
        assert got[k] <= limits[k], (k, got)
    assert got["lml_gap"] < 0.5 and got["posterior_gap"] < 0.15, got


@pytest.mark.parametrize("dtype,passes", [(torch.float32, True),
                                          (torch.bfloat16, False)])
@pytest.mark.parametrize("ref,cfg,cell,method", [
    (rom, OM, "om.100k.graph.sys", "systematic"),
    (rom, OM, "om.1m.graph.res", "residual"),
    (rsv, SV, "sv.100k.graph", "systematic")])
def test_control_fails_and_float32_reference_passes(ref, cfg, cell, method,
                                                     dtype, passes):
    limits = _limits(cell)
    gen = torch.Generator().manual_seed(21)
    y = torch.cumsum(torch.randn(cfg["t_max"], generator=gen), 0) * 0.3 \
        if ref is rom else torch.randn(cfg["t_max"], generator=gen) * 0.5
    ans = ref.reference_filter(gen, y, 3000, cfg, 0.5, method, dtype)
    got = ref.judge(ans, y, cfg, 0.5)
    exact_ok = all(got[k] <= limits[k] for k in EXACT)
    assert exact_ok == passes, got
