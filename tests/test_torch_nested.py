"""Combinators nested in combinators (genparticlefilters_tpu_torch/core/
combinators.py, core/packed.py), against the JAX package where it runs
and against exact Kalman log Zs everywhere.

Three linear-Gaussian shapes, each with an exact log Z:

- N1, a plate in an Unfold step: ``x_t ~ N(0.7·x_{t−1}, 0.6)``, then
  ``MapCombinator(obs, 8)`` with ``y_{t,k} ~ N(x_t, 0.5)``;
- N2, a plate of Unfolds: ``MapCombinator(Unfold(ar1_step, T), 4)``, four
  independent AR(1) series each observed at every step;
- N3, an Unfold in an Unfold step: each outer step runs an inner Unfold
  of 3 AR(1) sub-steps and observes the last sub-state.

Held against JAX on the same numpy inputs (float32 sums to atol 1e-5,
ints and layouts exactly): fully constrained ``generate`` weights,
``assess`` scores, the full re-scan update with an overwrite, the choice
layout, and the interop round trip of a JAX nested state. Where JAX fails,
the test asserts that it fails: these are reference faults, pinned and not
repaired (ROADMAP queue 3). The port's own paths are held to the exact
log Z at N=4000 (6·stderr + 0.05 over 4 seeds, every seed within 0.5
nat), and the per-particle form (``vmap_gfi``) to the batched form from
one seed.
"""

import math
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
import genparticlefilters_tpu.config as jcfg  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.packed import StaticColumn  # noqa
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)

A, Q, R = 0.7, 0.6, 0.5     # AR coefficient, process and observation sd
K1, K2, S3 = 8, 4, 3        # N1 plate, N2 plate, N3 inner sub-steps
NP = 6                      # particles of the parity runs


def build(g, T, batch_safe=True):
    """(N1, N2, N3) of package ``g`` at horizon ``T``; ``batch_safe=False``
    leaves every body unmarked (the per-particle interpretation)."""
    @g.gen
    def obs_k(x):
        g.trace("y", g.normal(x, R))

    plate = g.MapCombinator(obs_k, K1)

    @g.gen
    def n1_step(t, x):
        x = g.trace("x", g.normal(A * x, Q))
        g.trace("obs", plate, (x,))
        return x

    @g.gen
    def ar1_step(t, x):
        x = g.trace("x", g.normal(A * x, Q))
        g.trace("y", g.normal(x, R))
        return x

    @g.gen
    def sub_step(t, x):
        return g.trace("x", g.normal(A * x, Q))

    inner = g.Unfold(sub_step, S3)

    @g.gen
    def n3_step(t, x):
        xs = g.trace("sub", inner, (S3, x))
        x = xs[S3 - 1]
        g.trace("y", g.normal(x, R))
        return x

    for f in (obs_k, n1_step, ar1_step, sub_step, n3_step):
        f.batch_safe = batch_safe
    return (g.Unfold(n1_step, T), g.MapCombinator(g.Unfold(ar1_step, T), K2),
            g.Unfold(n3_step, T))


def G(seed):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Exact log Z
# ---------------------------------------------------------------------------

def kalman_log_z(y, a=A, q2=Q ** 2, r2=R ** 2):
    """log p(y) of ``x_t = a·x_{t−1} + N(0, q2)`` (``x_{−1} = 0``) observed
    by ``y_{t,k} ~ N(x_t, r2)``; ``y`` is ``[T]`` or ``[T, k]``, in
    float64 (sequential scalar updates within a step are exact)."""
    y = np.asarray(y, np.float64).reshape(len(y), -1)
    m, v, lz = 0.0, 0.0, 0.0
    for yt in y:
        m, v = a * m, a * a * v + q2
        for obs in yt:
            s = v + r2
            lz += -0.5 * (obs - m) ** 2 / s - 0.5 * math.log(2 * math.pi * s)
            k = v / s
            m, v = m + k * (obs - m), (1 - k) * v
    return lz


def exact_log_z(shape, y):
    if shape == "N1":
        return kalman_log_z(y)
    if shape == "N2":
        return sum(kalman_log_z(y[k]) for k in range(K2))
    # N3: three sub-steps make one AR step of coefficient a³ and the summed
    # variance
    return kalman_log_z(y, A ** S3, Q ** 2 * sum(A ** (2 * j)
                                                for j in range(S3)))


def simulate_data(shape, T, seed):
    """Observations of one trajectory of the shape, in numpy float32: N1
    ``[T, 8]``, N2 ``[4, T]``, N3 ``[T]``."""
    rng = np.random.default_rng(seed)

    def ar(n, a, q):
        x, out = 0.0, []
        for _ in range(n):
            x = a * x + q * rng.normal()
            out.append(x)
        return np.array(out)
    if shape == "N1":
        x = ar(T, A, Q)
        return (x[:, None] + R * rng.normal(size=(T, K1))).astype(np.float32)
    if shape == "N2":
        x = np.stack([ar(T, A, Q) for _ in range(K2)])
        return (x + R * rng.normal(size=(K2, T))).astype(np.float32)
    x = ar(T * S3, A, Q)[S3 - 1::S3]
    return (x + R * rng.normal(size=T)).astype(np.float32)


def test_exact_log_z_of_n3_equals_the_unrolled_chain():
    """N3's one-step model (a³, summed variance) against a Kalman filter on
    the unrolled sub-steps with the observation every third one."""
    y = simulate_data("N3", 6, 0)
    m, v, lz = 0.0, 0.0, 0.0
    for yt in y.astype(np.float64):
        for _ in range(S3):
            m, v = A * m, A * A * v + Q * Q
        s = v + R * R
        lz += -0.5 * (yt - m) ** 2 / s - 0.5 * math.log(2 * math.pi * s)
        k = v / s
        m, v = m + k * (yt - m), (1 - k) * v
    assert abs(exact_log_z("N3", y) - lz) < 1e-10


# ---------------------------------------------------------------------------
# Parity with JAX, every site constrained
# ---------------------------------------------------------------------------

T_PAR = 5
J_MODELS = dict(zip(("N1", "N2", "N3"), build(jg, T_PAR)))
T_MODELS = dict(zip(("N1", "N2", "N3"), build(tg, T_PAR)))


def _values(shape, seed, t=T_PAR):
    """Per-particle values of every site at steps < t, drawn from the
    model (numpy float32; typical values keep the float32 sums small)."""
    rng = np.random.default_rng(seed)

    def chain(*lead):
        x, out = np.zeros(lead[:-1] + (NP,)), []
        for _ in range(lead[-1]):
            x = A * x + Q * rng.normal(size=x.shape)
            out.append(x)
        return np.stack(out, -2)
    f32 = lambda v: v.astype(np.float32)  # noqa: E731
    if shape == "N1":
        x = chain(t)
        return {"x": f32(x), "y": f32(x[..., None]
                                     + R * rng.normal(size=(t, NP, K1)))}
    if shape == "N2":
        x = chain(K2, t)
        return {"x": f32(x), "y": f32(x + R * rng.normal(size=x.shape))}
    x = chain(t * S3).reshape(t, S3, NP)
    return {"x": f32(x), "y": f32(x[:, -1] + R * rng.normal(size=(t, NP)))}


def _choices(g, shape, vals, steps):
    """The same constraints for either package: the sites of ``steps``
    (N2: dense over its first ``len(steps)`` steps)."""
    arr = jnp.asarray if g is jg else torch.from_numpy
    e = lambda v: g.Entry(arr(np.ascontiguousarray(v)), True)  # noqa
    if shape == "N2":
        n = len(steps)
        pad = lambda v: np.concatenate(  # noqa: E731
            [v[:, :n], np.zeros_like(v[:, n:])], 1)
        return g.ChoiceMap({("x",): e(pad(vals["x"])),
                            ("y",): e(pad(vals["y"]))})
    out = {}
    for t in steps:
        out[(t, "y") if shape == "N3" else (t, "obs", "y")] = e(vals["y"][t])
        if shape == "N3":
            for s in range(S3):
                out[(t, "sub", s, "x")] = e(vals["x"][t, s])
        else:
            out[(t, "x")] = e(vals["x"][t])
    return g.ChoiceMap(out)


def _args(g, shape, t):
    if g is jg:
        return (t, jnp.zeros((K2,) if shape == "N2" else (), jnp.float32))
    return (t, torch.zeros((K2,) if shape == "N2" else ()))


def _generate(g, shape, t, vals, seed=0):
    model = (J_MODELS if g is jg else T_MODELS)[shape]
    key = jr.key(seed) if g is jg else G(seed)
    bi = (jg.core.gfi.batched_interpretation if g is jg
          else tg.batched_interpretation)
    with bi(NP):
        return model.generate(key, _args(g, shape, t),
                              _choices(g, shape, vals, range(t)))


def _logp_by_hand(shape, vals, t):
    """Σ log p of every site at steps < t, per particle, in float64."""
    def lp(v, m, s):
        return -0.5 * ((v - m) / s) ** 2 - math.log(s) \
            - 0.5 * math.log(2 * math.pi)
    x = {k: v.astype(np.float64) for k, v in vals.items()}
    out = np.zeros(NP)
    if shape == "N1":
        prev = np.zeros(NP)
        for s in range(t):
            out += lp(x["x"][s], A * prev, Q)
            out += lp(x["y"][s], x["x"][s][:, None], R).sum(1)
            prev = x["x"][s]
    elif shape == "N2":
        for k in range(K2):
            prev = np.zeros(NP)
            for s in range(t):
                out += lp(x["x"][k, s], A * prev, Q) + lp(x["y"][k, s],
                                                          x["x"][k, s], R)
                prev = x["x"][k, s]
    else:
        prev = np.zeros(NP)
        for s in range(t):
            for j in range(S3):
                out += lp(x["x"][s, j], A * prev, Q)
                prev = x["x"][s, j]
            out += lp(x["y"][s], prev, R)
    return out


@pytest.mark.parametrize("shape", ["N1", "N2", "N3"])
@pytest.mark.parametrize("t", [1, T_PAR])
def test_generate_weight_is_the_joint_log_density(shape, t):
    """Fully constrained: the port's weight and score are Σ log p by hand,
    at the O(k) extension (t = 1) and past it."""
    vals = _values(shape, 1)
    tr, w = _generate(tg, shape, t, vals)
    want = _logp_by_hand(shape, vals, t)
    np.testing.assert_allclose(_np(w), want, atol=1e-4)
    np.testing.assert_allclose(_np(tr.score), want, atol=1e-4)


@pytest.mark.parametrize("shape", ["N1", "N2", "N3"])
def test_generate_and_assess_match_jax(shape):
    """At t = T_PAR (JAX's scan path) both packages give the same weights,
    scores and assess scores."""
    vals = _values(shape, 2)
    jtr, jw = _generate(jg, shape, T_PAR, vals)
    ttr, tw = _generate(tg, shape, T_PAR, vals)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ttr.score), np.asarray(jtr.score),
                               atol=1e-5, rtol=0)
    with jg.core.gfi.batched_interpretation(NP):
        _, js = J_MODELS[shape].assess(_args(jg, shape, T_PAR),
                                       _choices(jg, shape, vals,
                                                range(T_PAR)))
    with tg.batched_interpretation(NP):
        _, ts = T_MODELS[shape].assess(_args(tg, shape, T_PAR),
                                       _choices(tg, shape, vals,
                                                range(T_PAR)))
    np.testing.assert_allclose(_np(ts), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ts), _np(ttr.score), atol=1e-5, rtol=0)


def _update(g, shape, tr, t, vals, seed=1):
    """The full re-scan update of ``tr`` to length ``t``, every site of
    steps < t constrained to ``vals`` (an overwrite of the old steps)."""
    bi = (jg.core.gfi.batched_interpretation if g is jg
          else tg.batched_interpretation)
    key = jr.key(seed) if g is jg else G(seed)
    with bi(NP):
        return g.update(key, tr, _args(g, shape, t),
                        (g.UnknownChange(), g.NoChange()),
                        _choices(g, shape, vals, range(t)))


@pytest.mark.parametrize("shape", ["N1", "N2", "N3"])
def test_full_rescan_update_with_overwrite(shape):
    """From t = 2 to t = 4, re-constraining steps 0-1: the weight is the
    new joint minus the old (nothing is sampled) and the discard holds the
    old values of the overwritten sites. N2 is held to JAX as well (N1's
    and N3's re-scans fail there, pinned faults below)."""
    old, new = _values(shape, 3), _values(shape, 4)
    ttr, _ = _generate(tg, shape, 2, old)
    ttr2, tw, _, td = _update(tg, shape, ttr, 4, new)
    want = _logp_by_hand(shape, new, 4) - _logp_by_hand(shape, old, 2)
    np.testing.assert_allclose(_np(tw), want, atol=1e-4)
    np.testing.assert_allclose(_np(ttr2.score), _logp_by_hand(shape, new, 4),
                               atol=1e-4)
    if shape == "N2":
        jtr, _ = _generate(jg, shape, 2, old)
        jtr2, jw, _, _ = _update(jg, shape, jtr, 4, new)
        np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(_np(ttr2.score), np.asarray(jtr2.score),
                                   atol=1e-5, rtol=0)
    if shape == "N2":
        x = td.entries[("x",)]
        np.testing.assert_array_equal(_np(x.value)[:, :2], old["x"][:, :2])
        # the active steps' rows (inactive rows are unspecified)
        st = ttr2.inner["steps"].inner["store"]
        rows = 4 * st.layout.R
        np.testing.assert_array_equal(
            _np(st.mat)[:, :rows],
            np.asarray(jtr2.inner["steps"].inner["store"].mat)[:, :rows])
    elif shape == "N1":
        np.testing.assert_array_equal(
            _np(td.resolve((0, "x")).value), old["x"][0])
        np.testing.assert_array_equal(
            _np(td.resolve((1, "obs", "y")).value), old["y"][1])
    else:
        np.testing.assert_array_equal(
            _np(td.resolve((1, "sub", 2, "x")).value), old["x"][1, 2])


@pytest.mark.parametrize("shape", ["N1", "N2", "N3"])
def test_choice_layout(shape):
    """``get_choices`` of the nested traces: the stored values at the
    active steps, each entry in its time-major/plate layout (N1's as in
    JAX), masked by the active steps."""
    vals = _values(shape, 5)
    ttr, _ = _generate(tg, shape, 3, vals)
    ch = ttr.get_choices()
    axes = tg.get_gen_fn(ttr).trace_choice_axes(ttr, 0)
    if shape == "N1":
        jtr, _ = _generate(jg, shape, T_PAR, vals)
        ttr, _ = _generate(tg, shape, T_PAR, vals)
        jch, ch = jtr.get_choices(), ttr.get_choices()
        assert set(ch.entries) == set(jch.entries)
        for k, e in ch.entries.items():
            np.testing.assert_array_equal(_np(e.value),
                                          np.asarray(jch.entries[k].value))
        assert axes == {("x",): 1, ("obs", "y"): 1}
        return
    if shape == "N2":
        assert axes == {("x",): 2, ("y",): 2}
        for a in ("x", "y"):
            e = ch.entries[(a,)]
            assert tuple(e.value.shape) == (K2, T_PAR, NP)
            assert tuple(e.mask.shape) == (K2, T_PAR)
            np.testing.assert_array_equal(_np(e.mask),
                                          np.arange(T_PAR)[None] < [[3]] * K2)
            np.testing.assert_array_equal(_np(e.value)[:, :3],
                                          vals[a][:, :3])
        return
    assert axes == {("y",): 1, ("sub", "x"): 2}
    e = ch.entries[("sub", "x")]
    assert tuple(e.value.shape) == (T_PAR, S3, NP)
    np.testing.assert_array_equal(
        _np(e.mask), (np.arange(T_PAR) < 3)[:, None].repeat(S3, 1))
    np.testing.assert_array_equal(_np(e.value)[:3], vals["x"][:3])
    np.testing.assert_array_equal(_np(tg.get_choices(ttr)[("y",)])[:3],
                                  vals["y"][:3])


def _j_obs(shape, y):
    if shape == "N1":
        return jg.ChoiceMap({("obs", "y"): jg.Entry(jnp.asarray(y), True)})
    return jg.ChoiceMap({("y",): jg.Entry(jnp.asarray(y), True)})


def _t_obs(shape, y):
    y = torch.from_numpy(y)
    if shape == "N1":
        return tg.ChoiceMap({("obs", "y"): tg.Entry(y, True)})
    return tg.ChoiceMap({("y",): tg.Entry(y, True)})


def test_reference_fault_plate_update_under_an_unfold():
    """Pinned reference fault: the JAX ``MapCombinator._update`` under an
    Unfold step fails on the empty discard's out_axes
    (genparticlefilters_tpu/core/combinators.py:1220-1232, :1180) on the
    O(k) extension, where a step's old plate is absent by a static mask:
    ``pf_initialize``, ``generate`` at t <= 2 and an ``Extend`` update.
    The full re-scan update runs there, and agrees with the port."""
    y = simulate_data("N1", T_PAR, 0)
    x0 = jnp.zeros((), jnp.float32)
    with pytest.raises(ValueError, match="out_axes"):
        jg.pf_initialize(jr.key(0), J_MODELS["N1"], (1, x0),
                         _j_obs("N1", y), 8)
    old, new = _values("N1", 10), _values("N1", 11)
    jtr, _ = _generate(jg, "N1", 3, old)
    with jg.core.gfi.batched_interpretation(NP):
        with pytest.raises(ValueError, match="out_axes"):
            jg.update(jr.key(1), jtr, _args(jg, "N1", 4),
                      (jg.Extend(1), jg.NoChange()),
                      _choices(jg, "N1", old, [3]))
    with pytest.raises(ValueError, match="out_axes"):
        _generate(jg, "N1", 2, old)
    ttr, _ = _generate(tg, "N1", 3, old)
    for t, vals, steps in ((4, old, [3]), (4, new, range(4)),
                           (3, new, range(3))):
        bi = jg.core.gfi.batched_interpretation
        with bi(NP):
            _, jw, _, _ = jg.update(jr.key(1), jtr, _args(jg, "N1", t),
                                    (jg.UnknownChange(), jg.NoChange()),
                                    _choices(jg, "N1", vals, steps))
        with tg.batched_interpretation(NP):
            _, tw, _, _ = tg.update(G(1), ttr, _args(tg, "N1", t),
                                    (tg.UnknownChange(), tg.NoChange()),
                                    _choices(tg, "N1", vals, steps))
        np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("shape", ["N2", "N3"])
def test_reference_fault_stacked_inner_store(shape):
    """Pinned reference fault: JAX reads an Unfold store stacked under
    another combinator (a plate of Unfolds, an Unfold in an Unfold step)
    as if it were unstacked (genparticlefilters_tpu/core/packed.py:220),
    so ``get_choices`` fails, and with it ``pf_initialize``'s layout guard;
    N3's full re-scan update fails the same way."""
    vals = _values(shape, 8)
    jtr, _ = _generate(jg, shape, T_PAR, vals)
    with pytest.raises(TypeError, match="reshape"):
        jtr.get_choices()
    y = simulate_data(shape, T_PAR, 0)
    args = _args(jg, shape, 1)
    with pytest.raises(TypeError, match="reshape"):
        jg.pf_initialize(jr.key(0), J_MODELS[shape], args, _j_obs(shape, y),
                         8)
    if shape == "N3":
        with pytest.raises(TypeError, match="reshape"):
            _update(jg, shape, jtr, T_PAR, _values(shape, 9))


def _j_state(shape, n=16, t=1):
    """A JAX filter state of the shape (its layout guard off: it fails on
    these shapes, see above), resampled once."""
    y = simulate_data(shape, T_PAR, 1)
    with jcfg.use_check_batched_layout(False):
        st = jg.pf_initialize(jr.key(2), J_MODELS[shape], _args(jg, shape, t),
                              _j_obs(shape, y), n)
    return st, y


def test_reference_fault_plate_of_unfolds_resample_leaves_the_store():
    """Pinned reference fault: JAX's ``MapCombinator.trace_axes`` gives the
    plate-stacked Unfold store ``mat [n, T*R, N]`` no particle axis
    (genparticlefilters_tpu/core/combinators.py:1274-1284), so a resample
    moves the scores and carries but leaves every particle's stored steps
    where they were. The port's spec puts the particle axis at 2."""
    from genparticlefilters_tpu.core.batching import axes_spec as j_axes
    from genparticlefilters_tpu_torch.core.batching import axes_spec
    jst, y = _j_state("N2")
    jmat = jst.traces.inner["steps"].inner["store"].mat
    assert j_axes(jst.traces).inner["steps"].inner["store"].mat is None
    out = jg.pf_resample(jr.key(3), jst.replace(
        log_weights=jnp.arange(16.0) * -1.0), "systematic", check=False)
    assert not np.array_equal(np.asarray(out.parents), np.arange(16))
    np.testing.assert_array_equal(
        np.asarray(out.traces.inner["steps"].inner["store"].mat),
        np.asarray(jmat))
    tst = state_from_numpy(T_MODELS["N2"], [np.asarray(x) for x in
                                           jax.tree_util.tree_leaves(jst)],
                           _args(tg, "N2", 1), _t_obs("N2", y),
                           device="cpu")
    assert axes_spec(tst.traces).inner["steps"].inner["store"].mat == 2


@pytest.mark.parametrize("shape", ["N2", "N3"])
def test_interop_round_trip(shape):
    """A JAX nested state into the port and back: JAX carries the inner
    length as an int32 leaf (N3: ``[T]`` per outer step; N2: ``[4]`` per
    element), the port on the host. The carried state's choices equal
    JAX's stored values, and it runs on through an update and a
    resample."""
    jst, y = _j_state(shape, t=2 if shape == "N3" else 1)
    arrays = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    t = 2 if shape == "N3" else 1
    tst = state_from_numpy(T_MODELS[shape], arrays, _args(tg, shape, t),
                           _t_obs(shape, y), device="cpu")
    back = state_to_numpy(tst)
    assert len(back) == len(arrays)
    static = 0
    for a, b in zip(back, arrays):
        if a.shape != b.shape:   # a Python int length: one value for all
            assert a.shape == () and (b == a).all()
            static += 1
            continue
        np.testing.assert_array_equal(a, b)
    sub = (tst.traces.inner["steps"] if shape == "N2"
           else tst.traces.inner["store"])
    if shape == "N3":
        cols = [e for e in sub.extras if isinstance(e, StaticColumn)]
        assert [list(c) for c in cols] == [[S3, S3] + [0] * (T_PAR - 2)] * 2
    else:
        # the elements' length and their args[0]
        assert static == 2 and sub.inner["t"] == 1 and sub.args[0] == 1
    ch = tst.traces.get_choices()
    x = ch.entries[("sub", "x") if shape == "N3" else ("x",)]
    assert bool(torch.isfinite(x.value).all())
    obs = _t_obs(shape, y)
    tst = tg.pf_update(G(1), tst, _args(tg, shape, t + 1),
                       (tg.UnknownChange(), tg.NoChange()), obs, check=False)
    assert bool(torch.isfinite(tst.log_weights).all())
    tg.pf_resample(G(2), tst, "systematic")


# ---------------------------------------------------------------------------
# Filters against the exact log Z; per particle against batched
# ---------------------------------------------------------------------------

T_F = 10


def nested_filter(gen, shape, model, y, n):
    """N1: ``Extend(1)`` updates, systematic resampling when the ESS falls
    below N/2, then MH on ``x`` of the last two steps through the
    window-2 regenerate. N2: full re-scan updates (``UnknownChange``) on
    the new length, residual resampling. N3: ``Extend(1)`` updates,
    systematic resampling. Every draw from ``gen``."""
    obs = _t_obs(shape, y)
    x0 = torch.zeros((K2,) if shape == "N2" else ())
    diffs = ((tg.UnknownChange(), tg.NoChange()) if shape == "N2"
             else (tg.Extend(1), tg.NoChange()))
    method = "residual" if shape == "N2" else "systematic"
    st = tg.pf_initialize(gen, model, (1, x0), obs, n)
    for t in range(1, T_F):
        if bool(tg.effective_sample_size(st) < n / 2):
            st = tg.pf_resample(gen, st, method, check=False)
            if shape == "N1":
                st = tg.pf_rejuvenate(
                    gen, st, tg.mh, (tg.select((t - 1, "x"), (t - 2, "x")),),
                    window=2)
        st = tg.pf_update(gen, st, (t + 1, x0), diffs, obs, check=False)
    return st


@pytest.mark.parametrize("shape", ["N1", "N2", "N3"])
def test_filter_meets_the_exact_log_z(shape):
    """At N=4000 over 4 seeds: the mean LML within 6·stderr + 0.05 of the
    exact log Z, every seed within 0.5 nat."""
    model = build(tg, T_F)[("N1", "N2", "N3").index(shape)]
    y = simulate_data(shape, T_F, 11)
    log_z = exact_log_z(shape, y)
    lmls = np.array([float(tg.log_ml_estimate(
        nested_filter(G(200 + s), shape, model, y, 4000)))
        for s in range(4)])
    se = lmls.std() / 2
    assert abs(lmls.mean() - log_z) < 6 * se + 0.05, (lmls, log_z)
    assert np.all(np.abs(lmls - log_z) < 0.5), (lmls, log_z)


@pytest.mark.parametrize("shape", ["N1", "N2", "N3"])
def test_per_particle_matches_batched(shape):
    """The shapes unmarked (``batch_safe=False``) run per particle through
    ``vmap_gfi``: from one seed, every verb of the filter — initialize,
    the update, resampling and MH — gives the batched path's weights and
    choices; vmap never falls back to its per-element loop."""
    y = simulate_data(shape, 4, 12)
    idx = ("N1", "N2", "N3").index(shape)
    out = []
    for safe in (True, False):
        model = build(tg, 4, batch_safe=safe)[idx]
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("error",
                                        message=".*performance drop.*")
                st = nested_filter_short(G(5), shape, model, y, 64)
        finally:
            torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        out.append(st)
    b, p = out
    np.testing.assert_allclose(_np(p.log_weights), _np(b.log_weights),
                               atol=1e-5)
    assert set(b.traces.get_choices().entries) == set(
        p.traces.get_choices().entries)
    addr = ("sub", "x") if shape == "N3" else "x"
    np.testing.assert_allclose(_np(tg.batched_choice(p, addr)),
                               _np(tg.batched_choice(b, addr)), atol=1e-6)


def nested_filter_short(gen, shape, model, y, n):
    """Two steps of :func:`nested_filter` with a resample and MH on ``x``
    (the whole trace, no window) between them."""
    obs = _t_obs(shape, y)
    x0 = torch.zeros((K2,) if shape == "N2" else ())
    diffs = ((tg.UnknownChange(), tg.NoChange()) if shape == "N2"
             else (tg.Extend(1), tg.NoChange()))
    st = tg.pf_initialize(gen, model, (1, x0), obs, n)
    st = tg.pf_update(gen, st, (2, x0), diffs, obs, check=False)
    st = tg.pf_resample(gen, st, "systematic", check=False)
    sel = (tg.select(("sub", "x")) if shape == "N3" else tg.select("x"))
    st = tg.pf_rejuvenate(gen, st, tg.mh, (sel,))
    return tg.pf_update(gen, st, (3, x0), diffs, obs, check=False)
