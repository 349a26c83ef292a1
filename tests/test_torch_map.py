"""``MapCombinator`` (genparticlefilters_tpu_torch/core/combinators.py)
against the JAX package, and an Unfold inside a @gen inside a filter.

- Mirrors of tests/test_combinators.py:22-151: simulate, generate,
  update and regenerate per particle with their hand-checked weights; the
  chain model through pf_initialize, resampling, MH and an update; the
  plate under batched interpretation (plate stacked at axis 1, a plate
  observation stored shared, the resampling gather).
- Parity with JAX given the same numpy inputs, every site constrained:
  generate and update, per particle and batched (weights to atol 1e-5,
  choices bit-equal).
- The plate model of the card's path 4p at its N=100K: MH on ``mu``
  through the call site, the LML against the conjugate log Z and the
  posterior mean of ``mu``.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from fixtures import lp_normal  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402


@tg.gen
def unit(t, mu):
    x = tg.trace("x", tg.normal(mu, 1.0))
    tg.trace("y", tg.normal(x, 0.5))
    return x


unit.batch_safe = True
plate = tg.MapCombinator(unit, 8)


@jg.gen
def j_unit(t, mu):
    x = jg.trace("x", jg.normal(mu, 1.0))
    jg.trace("y", jg.normal(x, 0.5))
    return x


j_unit.batch_safe = True
j_plate = jg.MapCombinator(j_unit, 8)


def G(seed):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return x.detach().cpu().numpy()


def _args():
    return (torch.arange(8), torch.zeros(8))


def test_map_simulate_and_choices():
    tr = plate.simulate(G(0), _args())
    xs, ys = _np(tr.get_choices()["x"]), _np(tr.get_choices()["y"])
    assert xs.shape == (8,)
    expect = sum(lp_normal(float(x), 0.0, 1.0) + lp_normal(float(y),
                                                             float(x), 0.5)
                 for x, y in zip(xs, ys))
    np.testing.assert_allclose(float(tr.score), expect, rtol=1e-5)
    np.testing.assert_array_equal(_np(tr.get_retval()), xs)


def test_map_generate_weight():
    ys = torch.linspace(-1, 1, 8)
    tr, w = plate.generate(G(1), _args(),
                           tg.ChoiceMap({("y",): tg.Entry(ys, True)}))
    xs = _np(tr.get_choices()["x"])
    expect = sum(lp_normal(float(y), float(x), 0.5)
                 for x, y in zip(xs, _np(ys)))
    np.testing.assert_allclose(float(w), expect, rtol=1e-4)
    _, score = tg.assess(plate, _args(), tr.get_choices())
    np.testing.assert_allclose(float(score), float(tr.score), atol=1e-5)


def test_map_update_and_regenerate():
    tr = plate.simulate(G(0), _args())
    new_ys = torch.full((8,), 0.3)
    tr2, w, _, disc = plate.update(G(1), tr, _args(), None, tg.ChoiceMap(
        {("y",): tg.Entry(new_ys, True)}))
    old_ys, xs = _np(tr.get_choices()["y"]), _np(tr.get_choices()["x"])
    expect = sum(lp_normal(0.3, float(x), 0.5) - lp_normal(float(y),
                                                           float(x), 0.5)
                 for x, y in zip(xs, old_ys))
    np.testing.assert_allclose(float(w), expect, rtol=1e-4)
    np.testing.assert_allclose(_np(disc.resolve(("y",)).value), old_ys,
                               atol=1e-6)
    tr3, rw = plate.regenerate(G(2), tr2, _args(), None, tg.select("x"))
    assert np.isfinite(float(rw))
    # regenerating x: weight = Σ lp(y | new x) − lp(y | old x)
    x3 = _np(tr3.get_choices()["x"])
    expect = sum(lp_normal(0.3, float(a), 0.5) - lp_normal(0.3, float(b),
                                                           0.5)
                 for a, b in zip(x3, xs))
    np.testing.assert_allclose(float(rw), expect, atol=1e-4)


def test_unfold_inside_gen_inside_pf():
    """Nested: a @gen model wrapping an Unfold wrapping a @gen step,
    through the whole filter pipeline."""
    @tg.gen
    def step(t, x, drift):
        x = tg.trace("x", tg.normal(x + drift, 1.0))
        tg.trace("y", tg.normal(x, 1.0))
        return x
    step.batch_safe = True
    chain = tg.Unfold(step, 4)

    @tg.gen
    def model(n):
        drift = tg.trace("drift", tg.normal(0.0, 1.0))
        tg.trace("chain", chain, (n, torch.zeros(()), drift))
        return drift
    model.batch_safe = True

    obs = tg.choicemap(*[(("chain", t, "y"), 0.5) for t in range(3)])
    st = tg.pf_initialize(G(0), model, (3,), obs, 256)
    st = tg.pf_resample(G(1), st, "systematic", check=False)
    st = tg.pf_rejuvenate(G(2), st, tg.mh, (tg.select("drift"),))
    st = tg.pf_update(G(3), st, (4,), (tg.UnknownChange(),),
                      tg.choicemap((("chain", 3, "y"), 0.7)))
    assert bool(torch.all(torch.isfinite(st.log_weights)))
    m = float(tg.mean(st, "drift"))
    assert np.isfinite(m) and abs(m) < 1.5


def _plate_model(tpkg, unit_fn):
    p = tpkg.MapCombinator(unit_fn, 8)

    @tpkg.gen
    def model():
        tpkg.trace("p", p, (tpkg_arange(tpkg), tpkg_zeros(tpkg)))
        return 0.0
    model.batch_safe = True
    return model


def tpkg_arange(pkg):
    return torch.arange(8) if pkg is tg else jnp.arange(8)


def tpkg_zeros(pkg):
    return torch.zeros(8) if pkg is tg else jnp.zeros(8)


def test_map_batched_interpretation():
    """Under batched interpretation the plate stacks at axis 1, scores stay
    per particle, a plate observation is stored shared, fully constrained
    weights equal JAX's, and resampling gathers the plate leaves."""
    model = _plate_model(tg, unit)
    ys = torch.linspace(-1, 1, 8)
    obs = tg.ChoiceMap({("p", "y"): tg.Entry(ys, True)})
    st = tg.pf_initialize(G(0), model, (), obs, 32)
    xs = tg.batched_choice(st, ("p", "x"))
    assert tuple(xs.shape) == (32, 8)
    assert tuple(st.log_weights.shape) == (32,)
    ch = st.traces.get_choices()
    assert tuple(ch.entries[("p", "y")].value.shape) == (8,)
    assert tuple(ch.entries[("p", "x")].value.shape) == (32, 8)
    xv = np.linspace(-0.5, 0.5, 8).astype(np.float32)
    tobs2 = tg.ChoiceMap({("p", "y"): tg.Entry(ys, True),
                          ("p", "x"): tg.Entry(torch.from_numpy(xv), True)})
    jobs2 = jg.ChoiceMap({("p", "y"): jg.Entry(jnp.linspace(-1, 1, 8), True),
                          ("p", "x"): jg.Entry(jnp.asarray(xv), True)})
    w_t = tg.pf_initialize(G(3), model, (), tobs2, 4).log_weights
    w_j = jg.pf_initialize(jr.key(3), _plate_model(jg, j_unit), (), jobs2,
                           4).log_weights
    np.testing.assert_allclose(_np(w_t), np.asarray(w_j), atol=1e-5)
    st2 = tg.pf_resample(G(2), st, "systematic", check=False)
    np.testing.assert_array_equal(
        _np(tg.batched_choice(st2, ("p", "x"))),
        _np(xs)[_np(st2.parents).astype(np.int64)])


def _constrained(seed, b):
    rng = np.random.default_rng(seed)
    shape = (8,) if b is None else (b, 8)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _cms(x, y):
    return (jg.ChoiceMap({("x",): jg.Entry(jnp.asarray(x), True),
                          ("y",): jg.Entry(jnp.asarray(y), True)}),
            tg.ChoiceMap({("x",): tg.Entry(torch.from_numpy(x), True),
                          ("y",): tg.Entry(torch.from_numpy(y), True)}))


@pytest.mark.parametrize("b", [None, 5])
def test_map_generate_and_update_match_jax(b):
    """Every site constrained: generate, then an update that overwrites
    every x and y, equal to JAX's (weights, scores, discards, choices)."""
    jcm, tcm = _cms(*_constrained(0, b))
    jcm2, tcm2 = _cms(*_constrained(1, b))
    mu = np.linspace(-1, 1, 8).astype(np.float32)
    jargs, targs = (jnp.arange(8), jnp.asarray(mu)), (torch.arange(8),
                                                     torch.from_numpy(mu))
    with jg.core.gfi.batched_interpretation(b):
        jtr, jw = j_plate.generate(jr.key(0), jargs, jcm)
        jtr2, jw2, _, jd = j_plate.update(jr.key(1), jtr, jargs, None, jcm2)
    with tg.batched_interpretation(b):
        ttr, tw = plate.generate(G(0), targs, tcm)
        ttr2, tw2, _, td = plate.update(G(1), ttr, targs, None, tcm2)
    for a, c in ((tw, jw), (ttr.score, jtr.score), (tw2, jw2),
                 (ttr2.score, jtr2.score)):
        np.testing.assert_allclose(_np(a), np.asarray(c), atol=1e-5, rtol=0)
    for k in ("x", "y"):
        np.testing.assert_array_equal(_np(ttr2.get_choices()[k]),
                                      np.asarray(jtr2.get_choices()[k]))
        np.testing.assert_array_equal(_np(td.resolve((k,)).value),
                                      np.asarray(jd.resolve((k,)).value))
    np.testing.assert_array_equal(_np(ttr2.get_retval()),
                                  np.asarray(jtr2.get_retval()))


def plate_model_4p():
    """The card's path 4p: mu ~ N(0, 1); at "plate", x_i ~ N(mu, 1),
    y_i ~ N(x_i, 0.5) for i < 8."""
    @tg.gen
    def model(y_index):
        mu = tg.trace("mu", tg.normal(0.0, 1.0))
        tg.trace("plate", plate, (y_index, mu))
        return mu
    model.batch_safe = True
    return model


def test_plate_model_mh_through_the_call_site():
    """Path 4p at its size, N=100K, with y_i = 0.5: pf_initialize,
    systematic resampling, then MH on mu through the call site (the
    shared [8] observation meets the [N] accept only where the layout says
    it is per particle). Over 8 seeds the mean LML within 0.05 of the
    conjugate log Z (y_i | mu ~ N(mu, 1.25) iid) and the posterior mean of
    mu within 6·stderr + 0.02."""
    y = np.full(8, 0.5)
    cov = 1.25 * np.eye(8) + 1.0
    log_z = float(-0.5 * y @ np.linalg.solve(cov, y)
                  - 0.5 * np.linalg.slogdet(2 * math.pi * cov)[1])
    post_mean = y.sum() / 1.25 / (1 + 8 / 1.25)
    obs = tg.ChoiceMap({("plate", "y"): tg.Entry(
        torch.from_numpy(y.astype(np.float32)), True)})
    model, n = plate_model_4p(), 100_000
    lmls, means = [], []
    for seed in range(8):
        gen = G(10 + seed)
        st = tg.pf_initialize(gen, model, (torch.arange(8),), obs, n)
        lmls.append(float(tg.log_ml_estimate(st)))
        st = tg.pf_resample(gen, st, "systematic", check=False)
        st, stats = tg.pf_move_accept(gen, st, tg.mh, (tg.select("mu"),), 2,
                                      return_stats=True)
        assert 0.05 < float(stats["accept_rate"]) < 1.0
        assert tuple(st.traces.get_choices()[("plate", "y")].shape) == (8,)
        means.append(float(tg.mean(st, "mu")))
    assert abs(np.mean(lmls) - log_z) < 0.05, (lmls, log_z)
    se = np.std(means) / math.sqrt(len(means))
    assert abs(np.mean(means) - post_mean) < 6 * se + 0.02, (means,
                                                             post_mean)
