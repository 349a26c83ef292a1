"""The object-motion filter as a whole: the port
(genparticlefilters_tpu_torch/models/object_motion.py and the verbs under
it) against the JAX package.

(a) Deterministic chain: a JAX pf_initialize state carried into the port,
    then T-1 rounds of systematic resampling (JAX's u0 fed through the
    port's seam) and Extend(1) updates whose new-step choices are
    constrained to the same numpy values. mat, carry and parents must be
    bit-equal after every round; scores, log weights and the LML agree to
    atol 1e-4 (float32 sin/log ulps accumulate over the steps).
(a') The same chain with residual resampling, JAX's exponentials fed
    through the port's ``e`` seam. Hit counts may differ only at float32
    ties (a query within 1e-5 relative of a bracket edge, in float64), in
    under 0.5% of the particles; every other slot is bit-equal.
(b) The MH pieces that take no randomness: the windowed forced pass and
    the accept-masked delta write.
(c) The port's own filter against exact enumeration of the posterior, for
    its default method (residual) and each method by name.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.config import use_check_batched_layout  # noqa
from genparticlefilters_tpu.models import object_motion as jom  # noqa: E402
from genparticlefilters_tpu.utils.weights import safe_softmax  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.tree import (  # noqa: E402
    tree_flatten, tree_unflatten)
from genparticlefilters_tpu_torch.core.packed import zeros_column  # noqa
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    object_motion as tom)

N, T = 2048, 8
# leaf positions in the state's flattening order (see interop.py)
SCORE, CARRY_Y, CARRY_M, MAT, Y_OBS, T_LEAF, LW, LML, PARENTS = (
    3, 4, 5, 6, 7, 8, 9, 10, 11)


def _leaves(jstate):
    return [np.array(x) for x in jax.tree_util.tree_flatten(jstate)[0]]


def _assert_states_match(jst, tst):
    a, b = _leaves(jst), state_to_numpy(tst)
    assert len(a) == len(b)
    for i in (CARRY_Y, CARRY_M, MAT, Y_OBS, T_LEAF, PARENTS):
        np.testing.assert_array_equal(b[i], a[i], err_msg=f"leaf {i}")
    for i in (SCORE, LW, LML):
        np.testing.assert_allclose(b[i], a[i], atol=1e-4, rtol=0,
                                   err_msg=f"leaf {i}")


def _start(seed=1):
    y_obs, _ = jom.synthesize_data(jr.key(42), T, 3)
    jst = jg.pf_initialize(jr.key(seed), jom.make_object_motion(T),
                           (1, jom.init_state()), jom.obs_dense(y_obs), N)
    tmodel = tom.make_object_motion(T)
    tx0 = tom.init_state("cpu")
    tobs = tom.obs_dense(torch.from_numpy(np.array(y_obs)))
    tst = state_from_numpy(tmodel, _leaves(jst), (1, tx0), tobs,
                           device="cpu")
    return y_obs, jst, tst, tx0, tobs


def _safe_u0_key(jst, base, delta=1e-3):
    """A key whose systematic u0 leaves every n·cumsum(w) − u0 (float64,
    from JAX's own float32 weights) at least ``delta`` = 4 ulps of float32
    at n away from an integer: there, a one-ulp difference in the two
    frameworks' float32 cumsums cannot move a hit count, so parents must
    agree exactly."""
    w, _ = safe_softmax(jst.log_weights)
    x = N * np.cumsum(np.asarray(w, np.float64))
    keys = jr.split(base, 4096)
    us = np.asarray(jax.vmap(lambda k: jr.uniform(k, (), jnp.float32))(keys),
                    np.float64)
    for k, u in zip(keys, us):
        d = x - u
        if np.min(np.abs(d - np.round(d))) > delta:
            return k, np.float32(u)
    raise AssertionError("no u0 with a float32-safe margin among 4096 keys")


def _step_values(rng, carry_y, t):
    """Choices for step t drawn from the model's dynamics given the carry."""
    mv = rng.random(N) < 0.5
    y = carry_y + np.where(mv, np.sin(t + 1.0), 0.0) + 0.01 * rng.normal(
        size=N)
    mvf = np.zeros((T, N), bool)
    yf = np.zeros((T, N), np.float32)
    mvf[t], yf[t] = mv, y
    return mvf, yf


def test_chain_parity_resample_and_extend():
    y_obs, jst, tst, tx0, tobs = _start()
    _assert_states_match(jst, tst)
    rng = np.random.default_rng(7)
    for t in range(1, T):
        key, u0 = _safe_u0_key(jst, jr.key(1000 + t))
        jst = jg.pf_resample(key, jst, "systematic", check=False)
        tst = tg.pf_resample(torch.Generator(), tst, "systematic",
                             check=False, u0=u0)
        _assert_states_match(jst, tst)

        mvf, yf = _step_values(rng, np.array(jst.traces.inner["carry"][0]),
                               t)
        jcm = jom.obs_dense(y_obs)
        jcm = jg.ChoiceMap({**jcm.entries,
                            ("moving",): jg.Entry(jnp.asarray(mvf), True),
                            ("y",): jg.Entry(jnp.asarray(yf), True)})
        tcm = tg.ChoiceMap({**tobs.entries,
                            ("moving",): tg.Entry(torch.from_numpy(mvf),
                                                  True),
                            ("y",): tg.Entry(torch.from_numpy(yf), True)})
        # the per-particle [T, N] constraints have no per-particle reading,
        # so JAX's layout self-check (which replays them per particle) is
        # off for this call
        with use_check_batched_layout(False):
            jst = jg.pf_update(jr.key(t), jst, (t + 1, jom.init_state()),
                               (jg.Extend(1), jg.NoChange()), jcm,
                               check=False)
        tst = tg.pf_update(torch.Generator(), tst, (t + 1, tx0),
                           (tg.Extend(1), tg.NoChange()), tcm, check=False)
        _assert_states_match(jst, tst)
    np.testing.assert_allclose(float(tg.log_ml_estimate(tst)),
                               float(jg.log_ml_estimate(jst)), atol=1e-4)


def _hit_counts(parents, n):
    return np.searchsorted(np.asarray(parents), np.arange(n), side="right")


def _residual_ties(lw, e, n, rel=1e-5):
    """Per particle, in float64 from JAX's log weights and exponentials:
    does a residual draw lie within ``rel`` of its residual-cumsum edge?"""
    lw = np.asarray(lw, np.float64)
    w32 = np.asarray(jnp.exp(lw - lw.max()) / jnp.sum(jnp.exp(lw - lw.max()))
                     ).astype(np.float32)
    scaled = (n * w32).astype(np.float32)
    det = np.floor(scaled)
    r64 = np.cumsum(scaled.astype(np.float64) - det)
    r64 /= r64[-1]
    k = n - int(det.sum())
    ce = np.cumsum(np.asarray(e, np.float64))
    u = np.sort(ce[:k] / ce[k])
    pos = np.searchsorted(u, r64)
    d = np.minimum(np.abs(r64 - u[np.clip(pos - 1, 0, k - 1)]),
                   np.abs(r64 - u[np.clip(pos, 0, k - 1)]))
    return d <= rel * r64


def test_chain_parity_residual_resample_and_extend():
    y_obs, jst, tst, tx0, tobs = _start(seed=2)
    rng = np.random.default_rng(8)
    tmodel = tom.make_object_motion(T)
    for t in range(1, T):
        key = jr.key(2000 + t)
        e = np.array(jr.exponential(key, (N + 1,), jnp.float32))
        # the float32 log weights agree only to 1e-4, and a 1e-5 change of
        # one weight can move a floor(N·w) and with it every later
        # residual draw: the resample reads JAX's weights bit for bit
        tst = tst.replace(log_weights=torch.from_numpy(
            np.array(jst.log_weights)))
        tie = _residual_ties(jst.log_weights, e, N)
        jst = jg.pf_resample(key, jst, "residual", check=False)
        tst = tg.pf_resample(torch.Generator(), tst, "residual",
                             check=False, e=e)
        jF = _hit_counts(jst.parents, N)
        tF = _hit_counts(tst.parents.numpy(), N)
        bad = np.nonzero(jF != tF)[0]
        assert np.all(tie[bad]) and len(bad) <= 0.005 * N, bad
        same = np.asarray(jst.parents) == tst.parents.numpy()
        np.testing.assert_array_equal(
            tst.traces.inner["store"].mat.numpy()[:, same],
            np.asarray(jst.traces.inner["store"].mat)[:, same])
        if not same.all():   # continue the chain from JAX's ancestry
            tst = state_from_numpy(tmodel, _leaves(jst), (1, tx0), tobs,
                                   device="cpu")
        _assert_states_match(jst, tst)

        mvf, yf = _step_values(rng, np.array(jst.traces.inner["carry"][0]),
                               t)
        jcm = jg.ChoiceMap({**jom.obs_dense(y_obs).entries,
                            ("moving",): jg.Entry(jnp.asarray(mvf), True),
                            ("y",): jg.Entry(jnp.asarray(yf), True)})
        tcm = tg.ChoiceMap({**tobs.entries,
                            ("moving",): tg.Entry(torch.from_numpy(mvf),
                                                  True),
                            ("y",): tg.Entry(torch.from_numpy(yf), True)})
        with use_check_batched_layout(False):
            jst = jg.pf_update(jr.key(t), jst, (t + 1, jom.init_state()),
                               (jg.Extend(1), jg.NoChange()), jcm,
                               check=False)
        tst = tg.pf_update(torch.Generator(), tst, (t + 1, tx0),
                           (tg.Extend(1), tg.NoChange()), tcm, check=False)
        _assert_states_match(jst, tst)


def _window_selection(lib, t_now, arange):
    steps = arange(T)
    m = (steps == t_now - 2) | (steps == t_now - 1)
    return lib.Selection({("moving",): m, ("y",): m})


def test_mh_pieces_match_jax():
    y_obs, jst, tst, tx0, tobs = _start(seed=3)
    for t in range(1, 4):   # three plain extensions: t_active = 4
        jst = jg.pf_update(jr.key(t), jst, (t + 1, jom.init_state()),
                           (jg.Extend(1), jg.NoChange()),
                           jom.obs_dense(y_obs), check=False)
    tst = state_from_numpy(tom.make_object_motion(T), _leaves(jst),
                           (4, tx0), tobs, device="cpu")
    jtr, ttr = jst.traces, tst.traces
    jsel = _window_selection(jg, 4, jnp.arange)
    tsel = _window_selection(tg, 4, torch.arange)

    # the forced old-value pass over the window
    with jg.core.gfi.batched_interpretation(N):
        jrv, jso, jsc = jtr.gen_fn._sel_logp_window(jtr, jtr.args, jsel, 2)
    with tg.batched_interpretation(N):
        trv, tso, tsc = ttr.gen_fn._sel_logp_window(ttr, ttr.args, tsel, 2)
    for a, b in zip(trv, jrv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tso.numpy(), np.asarray(jso), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-5,
                               rtol=0)

    # the accept-masked write of a regenerate delta: JAX's delta carried
    # into the port's delta format, applied under the same accept mask
    nc = (jg.NoChange(), jg.NoChange())
    with jg.core.gfi.batched_interpretation(N):
        jdelta, _ = jtr.gen_fn.regenerate_delta(jr.key(5), jtr, jtr.args, nc,
                                                jsel, window=2)
    proto = zeros_column(ttr.inner["store"])["steps"]
    _, proto_def = tree_flatten(proto)
    cols = []
    for t_c, active, col, state in jdelta["cols"]:
        assert bool(active)
        leaves = [torch.from_numpy(np.array(x))
                  for x in jax.tree_util.tree_flatten(col)[0]]
        cols.append((int(t_c), tree_unflatten(proto_def, leaves),
                     tuple(torch.from_numpy(np.array(s)) for s in state)))
    tdelta = {"cols": cols, "t_old": 4,
              "last_state": tuple(torch.from_numpy(np.array(s))
                                  for s in jdelta["last_state"]),
              "score_delta": torch.from_numpy(
                  np.array(jdelta["score_delta"])),
              "new_args": ttr.args}
    accept = np.random.default_rng(3).random(N) < 0.5
    with jg.core.gfi.batched_interpretation(N):
        jout = jtr.gen_fn.apply_regenerate_delta(jtr, jdelta,
                                                 jnp.asarray(accept))
    with tg.batched_interpretation(N):
        tout = ttr.gen_fn.apply_regenerate_delta(ttr, tdelta,
                                                 torch.from_numpy(accept))
    np.testing.assert_array_equal(tout.inner["store"].mat.numpy(),
                                  np.asarray(jout.inner["store"].mat))
    for a, b in zip(tout.inner["carry"], jout.inner["carry"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tout.score.numpy(), np.asarray(jout.score))


def test_exact_posterior_matches_the_jax_suite_oracle():
    # the port's ground truth is the same enumeration the JAX package's
    # own suite uses (tests/test_object_motion.py, T=6)
    from test_object_motion import T as T_JAX, _exact_posterior
    yo = np.random.default_rng(0).normal(0.0, 1.0, T_JAX)
    post, lml = tom.exact_posterior(yo)
    ref_post, ref_lml = _exact_posterior(yo)
    np.testing.assert_allclose(post, ref_post, rtol=1e-12, atol=1e-15)
    assert abs(lml - ref_lml) < 1e-9


def test_filter_matches_exact_posterior():
    T6 = 6
    y_obs, _ = tom.synthesize_data(torch.Generator().manual_seed(42), T6, 3)
    post, lml = tom.exact_posterior(y_obs.numpy())
    res, lmls = [], []
    for s in range(4):
        st = tom.object_motion_filter(torch.Generator().manual_seed(100 + s),
                                      y_obs, 1500, T6)
        assert st.traces.inner["t"] == T6
        res.append([float(tg.mean(st, (t, "moving"))) for t in range(T6)])
        lmls.append(float(tg.log_ml_estimate(st)))
    res = np.array(res)
    est = res.mean(0)
    stderr = res.std(0) / np.sqrt(len(res)) + 1e-3
    assert np.all(np.abs(est - post) < 6 * stderr + 0.03), (est, post)
    assert abs(np.mean(lmls) - lml) < 0.2, (np.mean(lmls), lml)


@pytest.mark.parametrize("method", ["residual", "multinomial", "stratified",
                                    "systematic"])
def test_filter_matches_exact_posterior_by_method(method):
    T6 = 6
    y_obs, _ = tom.synthesize_data(torch.Generator().manual_seed(42), T6, 3)
    post, lml = tom.exact_posterior(y_obs.numpy())
    res, lmls = [], []
    for s in range(4):
        st = tom.object_motion_filter(torch.Generator().manual_seed(300 + s),
                                      y_obs, 1500, T6,
                                      resample_method=method)
        res.append([float(tg.mean(st, (t, "moving"))) for t in range(T6)])
        lmls.append(float(tg.log_ml_estimate(st)))
    res = np.array(res)
    est = res.mean(0)
    stderr = res.std(0) / np.sqrt(len(res)) + 1e-3
    assert np.all(np.abs(est - post) < 6 * stderr + 0.03), (est, post)
    assert abs(np.mean(lmls) - lml) < 0.2, (np.mean(lmls), lml)
