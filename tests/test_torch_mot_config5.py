"""Config 5 on the port's normal path: the multi-object tracking filter
(``models/multi_object.py`` ``mot_particle_filter``) through
``run_particle_filter`` with an online resize schedule, held to the
benchmark's plain reference (``smcbench/reference/multi_object_tracking.py``,
float64, nothing of the port).

On the CPU, at N=4,000, K=4, T=10 on config 5's schedule scaled to
N -> N/2 -> N: ``judge`` reads the cell's limits on its exact numbers on 4
seeds; the mean LML over 8 seeds lies within 6 standard errors (+ 0.05) of
the exact Kalman LML; given the same draws through the port's seams (``u0``,
``e``), the systematic resample and the residual and multinomial resizes
pick the reference's parents bit for bit; the ESS threshold follows the
count the state holds; the count after each scheduled step is the
schedule's; the resize draws before the step's check (a plain loop, bit
for bit); the ``mot.*`` spans; and, pinned by stored digests of small
runs, ``sv_particle_filter`` and ``mot_particle_filter`` without a schedule
return the states they returned before the schedule existed.

Marked ``chip``, on the card (this file imports no JAX: run it there with
``python -m pytest --noconftest tests/test_torch_mot_config5.py``): the
captured config-5 filter at N=1M replays bit-equal to its eager run from
one generator state; its graph holds 9 IF nodes and the two resizes; a
traced replay logs two ``mot.resize`` device spans; and SV's captured graph
keeps its node count and its replay against a capture of the loop as it was
before the schedule.
"""

import hashlib
import importlib
import json
import math
import statistics
from pathlib import Path

import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.core.tree import tree_leaves
from genparticlefilters_tpu_torch.models import multi_object as mo
from genparticlefilters_tpu_torch.models import stochastic_volatility as tsv
from genparticlefilters_tpu_torch.smc import algorithms
from smcbench.reference import multi_object_tracking as R

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "smcbench" / "configs"
                     / "multi_object_tracking.json").read_text())
LIMITS = json.loads((ROOT / "smcbench" / "workloads" / "mot.1m.graph.json")
                    .read_text())["limits"]
EXACT = ("score_gap", "weight_gap", "sibling_mismatch", "ess_violations",
         "parents_bad", "count_bad")
T = CONFIG["t_max"]
N = 4000
P = mo.MOTParams(CONFIG["n_objects"], CONFIG["q"], CONFIG["r"], CONFIG["s0"])
SCHEDULE = mo.mot_resize_schedule(N, T)


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda")


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _sequence(seed, k=4, device="cpu"):
    """``[T, K, 2]`` observations drawn from the model."""
    eps = torch.randn((2, T, k, 2), generator=_gen(seed, device),
                      device=device)
    sd = torch.full((T, 1, 1), P.q, device=device)
    sd[0] = P.s0
    return torch.cumsum(sd * eps[0], 0) + P.r * eps[1]


def _answer(state, n0):
    ch = state.traces.get_choices()
    return {"latents": {"x": ch[("x",)]}, "log_weights": state.log_weights,
            "lml": tg.log_ml_estimate(state), "parents": state.parents,
            "score": state.traces.score, "particles": n0}


def test_the_schedule_is_config_5s():
    assert SCHEDULE == {3: (N // 2, "residual"), 6: (N, "multinomial")}
    assert R.schedule_of(CONFIG) == mo.mot_resize_schedule(1_000_000, T)


@pytest.mark.parametrize("seed", range(4))
def test_judge_reads_inside_the_cells_limits(seed):
    y = _sequence(100 + seed)
    st = mo.mot_particle_filter(_gen(seed), y, N, T, P,
                                resize_schedule=SCHEDULE)
    got = R.judge(_answer(st, N), y, CONFIG, 0.5, SCHEDULE)
    for k in EXACT:
        assert got[k] <= LIMITS[k], (k, got)
    # the statistical numbers at N = 4,000, where the first step keeps a
    # few effective particles of 4,000 (the prior's sd 2 against the
    # observations' 0.5 in 8 coordinates): finite, and the posterior mean
    # within a prior sd
    assert math.isfinite(got["lml_gap"]) and got["posterior_gap"] < P.s0


def test_mean_lml_over_eight_seeds_is_the_kalman_lml():
    y = _sequence(7)
    exact = R.exact_lml(y, CONFIG)
    lmls = [float(tg.log_ml_estimate(mo.mot_particle_filter(
        _gen(20 + s), y, N, T, P, resize_schedule=SCHEDULE)))
        for s in range(8)]
    se = statistics.stdev(lmls) / math.sqrt(len(lmls))
    assert abs(statistics.mean(lmls) - exact) <= 6 * se + 0.05, (lmls, exact)


def _filtered(seed, n=N, k=4):
    """A state after three steps of the filter (real, uneven weights)."""
    y = _sequence(seed, k)[:3]
    p = P._replace(n_objects=k)
    return mo.mot_particle_filter(_gen(seed), y, n, 3, p, ess_frac=0.0)


@pytest.mark.parametrize("seed", [1, 2])
def test_systematic_resample_picks_the_reference_parents(seed):
    st = _filtered(seed)
    u0 = torch.rand((), generator=_gen(50 + seed))
    got = tg.pf_resample(None, st, "systematic", check=False, u0=u0)
    want = R.systematic(None, R.normalized(st.log_weights), u0=u0)
    assert torch.equal(got.parents.long(), want)


@pytest.mark.parametrize("m", [N // 2, N, 2 * N])
@pytest.mark.parametrize("method", ["residual", "multinomial"])
def test_resizes_pick_the_reference_parents(method, m):
    st = _filtered(3)
    e = torch.empty(m + 1).exponential_(generator=_gen(60))
    got = tg.pf_resize(None, st, m, method, check=False, e=e)
    w = R.normalized(st.log_weights)
    want = R.RESIZES[method](None, w, m, e=e)
    assert got.n_particles == m
    assert torch.equal(got.parents.long(), want)
    # the traces gathered by those parents, the weights reset and the
    # LML folded
    x, x_new = (s.traces.get_choices()[("x",)] for s in (st, got))
    assert torch.equal(x_new, x[:, want])
    assert torch.equal(got.log_weights, torch.zeros(m))
    fold = torch.logsumexp(st.log_weights.double(), 0) - math.log(N)
    assert float(got.log_ml_est) == pytest.approx(float(fold), abs=1e-4)


def _recorded(monkeypatch):
    """Each ESS check's (ESS, count held) and whether it resampled."""
    checks = []
    ess_fn = algorithms.ess_below
    resample_fn = algorithms.pf_resample

    def ess(log_weights, threshold):
        low, v = ess_fn(log_weights, threshold, with_ess=True)
        checks.append([float(v), log_weights.shape[0], False])
        return low

    def resample(*a, **k):
        checks[-1][2] = True
        return resample_fn(*a, **k)
    monkeypatch.setattr(algorithms, "ess_below", ess)
    monkeypatch.setattr(algorithms, "pf_resample", resample)
    return checks


@pytest.mark.parametrize("k", [1, 4])
def test_the_threshold_follows_the_current_count(k, monkeypatch):
    checks = _recorded(monkeypatch)
    mo.mot_particle_filter(_gen(8), _sequence(9, k), N, T,
                           P._replace(n_objects=k), resize_schedule=SCHEDULE)
    assert len(checks) == T - 1
    for ess, n, resampled in checks:
        assert resampled == (ess < 0.5 * n), checks
    # no check at N/2 resamples above N/4
    assert not [c for c in checks if c[1] == N // 2 and c[2]
                and c[0] >= N / 4], checks
    if k == 1:
        # the test bites: a check at N/2 whose ESS lay between N/4 and
        # N/2, which a threshold of the initial count would resample
        assert [c for c in checks if c[1] == N // 2 and not c[2]
                and N / 4 <= c[0] < N / 2], checks


def test_the_count_after_each_scheduled_step(monkeypatch):
    checks = _recorded(monkeypatch)
    st = mo.mot_particle_filter(_gen(10), _sequence(11), N, T, P,
                                resize_schedule=SCHEDULE)
    assert [c[1] for c in checks] == [N, N, N // 2, N // 2, N // 2,
                                      N, N, N, N]
    assert st.n_particles == N and st.traces.score.shape == (N,)
    half = mo.mot_particle_filter(_gen(10), _sequence(11), N, T, P,
                                  resize_schedule={3: (N // 2, "residual")})
    assert half.n_particles == N // 2


def _plain_loop(gen, y, n, schedule, ess_frac=0.5):
    """The config-5 filter as a plain loop: before step t the scheduled
    resize, then the ESS check against the count held, then the update."""
    model = mo.make_mot_model(T, P)
    x0 = torch.zeros((P.n_objects, 2))
    obs = mo.mot_obs_dense(y)
    state = tg.pf_initialize(gen, model, (1, x0), obs, n)
    for t in range(1, T):
        if t in schedule:
            state = tg.pf_resize(gen, state, schedule[t][0], schedule[t][1],
                                 check=False)
        if bool(tg.effective_sample_size(state)
                < ess_frac * state.n_particles):
            state = tg.pf_resample(gen, state, "systematic", check=False)
        state = tg.pf_update(gen, state, (t + 1, x0),
                             (tg.Extend(1), tg.NoChange()), obs, check=False)
    return state


@pytest.mark.parametrize("ess_frac", [0.5, 1.5])
def test_the_resize_draws_before_the_check(ess_frac):
    y = _sequence(12)
    got = mo.mot_particle_filter(_gen(13), y, 512, T, P, ess_frac=ess_frac,
                                 resize_schedule=mo.mot_resize_schedule(512, T))
    want = _plain_loop(_gen(13), y, 512, mo.mot_resize_schedule(512, T),
                       ess_frac)
    assert _digest(got) == _digest(want)


def test_the_mot_spans():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mo.mot_particle_filter(_gen(14), _sequence(15), 256, T, P,
                               ess_frac=1.5,
                               resize_schedule=mo.mot_resize_schedule(256, T))
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("mot.initialize") == 1
    assert counts.get("mot.resize") == 2
    for name in ("mot.ess_check", "mot.resample", "mot.update"):
        assert counts.get(name) == T - 1, (name, counts.get(name))


def test_schedule_refusals():
    with pytest.raises(ValueError, match="step"):
        algorithms._check_schedule({0: (10, "residual")}, T, None)
    with pytest.raises(ValueError, match="step"):
        algorithms._check_schedule({T: (10, "residual")}, T, None)
    with pytest.raises(ValueError, match="positive"):
        algorithms._check_schedule({3: (0, "residual")}, T, None)
    with pytest.raises(NotImplementedError, match="sharded"):
        algorithms._check_schedule({3: (10, "residual")}, T, object())
    assert algorithms._check_schedule(None, T, object()) == {}


def _digest(state) -> str:
    h = hashlib.sha256()
    for x in tree_leaves(state):
        if isinstance(x, torch.Tensor):
            h.update(str((tuple(x.shape), x.dtype)).encode())
            if x.numel():
                h.update(x.detach().reshape(-1).contiguous().cpu()
                         .view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())
    return h.hexdigest()


#: digests of small runs, taken before run_particle_filter had a schedule
DIGESTS = {
    "mot": "667c583dc0a9176b68e68f4df2293bc84a3419e502dae8a0b3bfd014f05bed0c",
    "sv": "f398495fd32d9612269870fc81ab9941dd068e1bbc0c848ec3765821f56feeb0",
}


def test_without_a_schedule_the_filters_return_what_they_did():
    y = torch.randn((6, 4, 2), generator=_gen(1)) * 2
    st = mo.mot_particle_filter(_gen(2), y, 200, 6, mo.MOTParams())
    assert _digest(st) == DIGESTS["mot"]
    ys = torch.randn(8, generator=_gen(3)) * 0.6
    st = tsv.sv_particle_filter(_gen(4), ys, 200, 8,
                                tsv.SVParams(-0.9, 0.97, 0.15))
    assert _digest(st) == DIGESTS["sv"]


# --- on the card -----------------------------------------------------------

def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape or not torch.equal(x, y):
                return False
    return True


@pytest.mark.chip
def test_captured_config5_replays_its_eager_run(card):
    y = _sequence(16, device=card)
    n = 1_000_000
    kw = dict(ess_frac=1.5, resize_schedule=mo.mot_resize_schedule(n, T))
    gen = _gen(0, card)
    run = mo.mot_particle_filter_captured(gen, y, n, T, P, **kw)
    gen.manual_seed(11)
    eager = mo.mot_particle_filter(gen, y, n, T, P, **kw)
    gen.manual_seed(11)
    replay = run(y)
    assert replay.n_particles == n
    assert _same(replay, eager)


@pytest.mark.chip
def test_captured_config5_holds_nine_if_nodes_and_two_resizes(card):
    from genparticlefilters_tpu_torch.ops import fused_gather as fg
    y = _sequence(17, device=card)
    n = 1_000_000
    counts = {}
    for sched in (None, mo.mot_resize_schedule(n, T)):
        g1, g2 = (fg.resample_gather_split.launches,
                  fg.resample_gather_split_u.launches)
        run = mo.mot_particle_filter_captured(_gen(0, card), y, n, T, P,
                                              resize_schedule=sched)
        counts[sched is None] = (run.nodes,
                                 fg.resample_gather_split.launches - g1,
                                 fg.resample_gather_split_u.launches - g2)
        st = run(y)
        assert st.n_particles == n
    # the warm-up and the capture each: 9 resamples (G1) in the IF
    # bodies; with the schedule also the residual resize (G2 count + G1)
    # and the multinomial resize (G2)
    assert counts[True] == (9, 2 * 9, 0)
    assert counts[False] == (9, 2 * 10, 2 * 2)


@pytest.mark.chip
def test_a_traced_replay_logs_the_resize_spans(card):
    from genparticlefilters_tpu_torch.utils.spans import (
        device_spans, device_span_totals)
    y = _sequence(18, device=card)
    n = 100_000
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        run = mo.mot_particle_filter_captured(
            _gen(0, card), y, n, T, P,
            resize_schedule=mo.mot_resize_schedule(n, T))
    finally:
        prof.stop()
    device_spans(reset=True)
    for _ in range(3):
        run(y)
    torch.cuda.synchronize()
    totals = device_span_totals(device_spans())
    assert len(totals) == 3
    for r in totals:
        assert r["mot.resize"].count == 2 and r["mot.resize"].ns > 0
        assert r["mot.update"].count == T - 1


def _old_run_particle_filter(gen, model, t_max, n_particles, step_args_fn,
                             obs_fn, ess_frac=0.5,
                             resample_method="systematic",
                             rejuvenate_fn=None, span_prefix="smc"):
    """run_particle_filter's loop as it was before the schedule."""
    from genparticlefilters_tpu_torch.smc.capture import (device_cond,
                                                          host_pred)
    from genparticlefilters_tpu_torch.utils.spans import span
    with span(f"{span_prefix}.initialize"):
        state = tg.pf_initialize(gen, model, step_args_fn(0), obs_fn(0),
                                 n_particles)
    diffs = (tg.Extend(1),) + tuple(
        tg.NoChange() for _ in range(len(step_args_fn(0)) - 1))
    for t in range(1, t_max):
        with span(f"{span_prefix}.ess_check"):
            low = host_pred(algorithms.ess_below(
                state.log_weights, ess_frac * n_particles))
        state = device_cond(low, lambda s: algorithms._resample_rejuvenate(
            gen, s, resample_method, rejuvenate_fn, t, span_prefix), state,
            donate=True)
        with span(f"{span_prefix}.update"):
            state = tg.pf_update(gen, state, step_args_fn(t), diffs,
                                 obs_fn(t), check=False, donate=True)
    return state


@pytest.mark.chip
def test_sv_graph_keeps_its_nodes_and_its_replay(card, monkeypatch):
    from genparticlefilters_tpu_torch.smc.capture import capture
    from genparticlefilters_tpu_torch.utils.spans import _graph_nodes
    cap = importlib.import_module("genparticlefilters_tpu_torch.smc.capture")
    y = tsv.synthesize_sv_data(_gen(3, card), 100, tsv.SVParams())
    found, outs = {}, {}
    for old in (False, True):
        counts = []
        if old:
            monkeypatch.setattr(tsv, "run_particle_filter",
                                _old_run_particle_filter)

        def counted(*a, **k):
            out = tsv.sv_particle_filter(*a, **k)
            if torch.cuda.is_current_stream_capturing():
                counts.append(_graph_nodes(
                    [g for nd in cap._BODIES[-1].nodes for g in nd.graphs]))
            return out
        gen = _gen(0, card)
        run = capture(counted, gen, y, 100_000, 100, tsv.SVParams())
        gen.manual_seed(11)
        outs[old] = run(y)
        found[old] = counts[-1]
    assert found[False] == found[True], found
    assert found[False]["conditionals"] == 99
    assert _same(outs[False], outs[True])
