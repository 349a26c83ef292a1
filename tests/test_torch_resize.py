"""Resizing (genparticlefilters_tpu_torch/smc/resize.py) against the JAX
package on the same states, carried across by ``interop``: multi-object
tracking states (the config-5 model) and an object-motion state.

Given the same draws (JAX's exponentials or uniform fed through the
port's ``e``/``u`` seams) resizing is float compares and integer work on
the same weights, so parents and traces are bit-equal to JAX's; so are
the weights and the LML where both sides compute them with the same
float32 operations. The log-space threshold of optimal resizing is a
log-cumsum, which the two frameworks associate differently: it agrees to
1e-5. Replicate, dereplicate (keepfirst) and coalesce are deterministic
and bit-equal. The rest are invariants: ancestry, LML folding, block
averages."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import multi_object as jmot  # noqa: E402
from genparticlefilters_tpu.models import object_motion as jom  # noqa: E402
from genparticlefilters_tpu.smc import resize as jrz  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import tree_take  # noqa
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from genparticlefilters_tpu_torch.models import multi_object as tmot  # noqa
from genparticlefilters_tpu_torch.models import object_motion as tom  # noqa
from genparticlefilters_tpu_torch.smc import resize as trz  # noqa: E402

K, T, N = 3, 4, 100


def _leaves(jstate):
    return [np.array(x) for x in jax.tree_util.tree_flatten(jstate)[0]]


def _y(seed, t=T, k=K):
    return np.random.default_rng(seed).normal(0.0, 1.5, (t, k, 2)).astype(
        np.float32)


def _mot_pair(seed=0, n=N, masked=False):
    """A JAX MOT state after ``pf_initialize`` with T observed steps and the
    port's copy of it. ``masked`` constrains ``y`` with a [T] mask array,
    which stores it per particle (no shared leaves); otherwise ``y`` is
    stored shared, as the filter does."""
    y = _y(seed)
    jp, tp = jmot.MOTParams(n_objects=K), tmot.MOTParams(n_objects=K)
    if masked:
        jobs = jg.ChoiceMap({("y",): jg.Entry(jnp.asarray(y),
                                              jnp.ones((T,), bool))})
        tobs = tg.ChoiceMap({("y",): tg.Entry(torch.from_numpy(y),
                                              torch.ones(T, dtype=bool))})
    else:
        jobs = jmot.mot_obs_dense(jnp.asarray(y))
        tobs = tmot.mot_obs_dense(torch.from_numpy(y))
    jst = jg.pf_initialize(jr.key(seed), jmot.make_mot_model(T, jp),
                           (T, jnp.zeros((K, 2), jnp.float32)), jobs, n)
    tst = state_from_numpy(tmot.make_mot_model(T, tp), _leaves(jst),
                           (T, torch.zeros((K, 2))), tobs, device="cpu")
    return jst, tst


def _om_pair(seed=1, n=N):
    y = np.random.default_rng(seed).normal(0.0, 0.5, (6,)).astype(np.float32)
    jst = jg.pf_initialize(jr.key(seed), jom.make_object_motion(6),
                           (4, jom.init_state()),
                           jom.obs_dense(jnp.asarray(y)), n)
    tst = state_from_numpy(tom.make_object_motion(6), _leaves(jst),
                           (4, tom.init_state("cpu")),
                           tom.obs_dense(torch.from_numpy(y)), device="cpu")
    return jst, tst


def _assert_same_state(jst, tst):
    """Every leaf bit-equal: traces, log weights, LML, parents."""
    a, b = _leaves(jst), state_to_numpy(tst)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x, err_msg=f"leaf {i}")


def _ancestry_ok(old, new):
    return all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tree_take(old.traces, new.parents)),
        tree_leaves(new.traces)) if isinstance(a, torch.Tensor))


@pytest.mark.parametrize("method", ["multinomial", "residual"])
@pytest.mark.parametrize("n_new", [50, 150])
@pytest.mark.parametrize("use_priority", [False, True])
def test_resize_matches_jax_given_the_draws(method, n_new, use_priority):
    jst, tst = _mot_pair(seed=n_new + use_priority)
    key = jr.key(7)
    e = np.array(jr.exponential(key, (n_new + 1,), jnp.float32))
    jp = (lambda w: w / 2) if use_priority else None
    jnew = jg.pf_resize(key, jst, n_new, method, priority_fn=jp)
    tnew = tg.pf_resize(None, tst, n_new, method, e=e,
                        priority_fn=(lambda w: w / 2) if use_priority
                        else None)
    assert tnew.n_particles == n_new
    _assert_same_state(jnew, tnew)
    assert _ancestry_ok(tst, tnew)
    np.testing.assert_allclose(float(tg.log_ml_estimate(tnew)),
                               float(tg.log_ml_estimate(tst)), atol=1e-4)
    if method == "residual":
        lp = tst.log_weights.double() / (2 if use_priority else 1)
        w = torch.softmax(lp, 0).numpy()
        counts = np.bincount(tnew.parents.numpy(), minlength=N)
        assert (counts >= np.floor(w * n_new).astype(int)).all()


@pytest.mark.parametrize("n_new", [25, 50])
def test_optimal_resize_matches_jax_given_u(n_new):
    jst, tst = _mot_pair(seed=3)
    key = jr.key(11)
    u = np.float32(jr.uniform(key, (), jnp.float32))
    jnew = jg.pf_resize(key, jst, n_new, "optimal")
    tnew = tg.pf_resize(None, tst, n_new, "optimal", u=u)
    np.testing.assert_array_equal(tnew.parents.numpy(),
                                  np.asarray(jnew.parents))
    _assert_same_state(jnew, tnew)
    assert len(np.unique(tnew.parents.numpy())) == n_new
    assert _ancestry_ok(tst, tnew)
    np.testing.assert_allclose(float(tg.log_ml_estimate(tnew)),
                               float(tg.log_ml_estimate(tst)), rtol=1e-3,
                               atol=2e-3)


def test_optimal_resize_unique_at_a_million():
    # the stream's float64 cumsum: no survivor is drawn twice at N=2^20
    n = 1 << 20
    lw = torch.from_numpy(np.random.default_rng(5).normal(
        0.0, 3.0, n).astype(np.float32))
    st = tg.ParticleFilterState({"x": torch.arange(n, dtype=torch.int32)},
                                lw, torch.zeros(()),
                                torch.arange(n, dtype=torch.int32))
    for u in (0.02, 0.98):
        out = trz.pf_optimal_resize(None, st, n // 4, u=u)
        assert torch.unique(out.parents).numel() == n // 4
        assert torch.equal(out.traces["x"], out.parents)


@pytest.mark.parametrize("m", [10, 100, 500])
def test_log_inv_w_threshold_matches_jax(m):
    lw = np.random.default_rng(m).normal(0.0, 10.0, 1000).astype(np.float32)
    lw[:5] = -np.inf
    ref = float(jrz._log_inv_w_threshold(jnp.asarray(lw), m))
    got = float(trz._log_inv_w_threshold(torch.from_numpy(lw), m))
    assert abs(got - ref) <= 1e-5
    w = np.exp(lw - lw.max())
    w /= w.sum()
    np.testing.assert_allclose(
        float(trz.find_inv_w_threshold(torch.from_numpy(w.astype(
            np.float32)), m)),
        float(jrz.find_inv_w_threshold(jnp.asarray(w, jnp.float32), m)),
        rtol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
def test_replicate_and_dereplicate_match_jax(layout):
    jst, tst = _mot_pair(seed=4, n=20)
    jrep = jg.pf_replicate(jst, 5, layout=layout)
    trep = tg.pf_replicate(tst, 5, layout=layout)
    _assert_same_state(jrep, trep)
    assert _ancestry_ok(tst, trep)
    jder = jg.pf_dereplicate(jr.key(0), jrep, 5, layout=layout,
                             method="keepfirst")
    tder = tg.pf_dereplicate(None, trep, 5, layout=layout,
                             method="keepfirst")
    _assert_same_state(jder, tder)
    # keepfirst inverts replicate exactly
    for a, b in zip(state_to_numpy(tder)[:-1], state_to_numpy(tst)[:-1]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(tg.log_ml_estimate(tder), tg.log_ml_estimate(tst))


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
def test_dereplicate_sample_invariants(layout):
    _, tst = _om_pair(seed=2, n=5)
    rep = tg.pf_replicate(tst, 20, layout=layout)
    # perturb the copies' weights so the blocks differ inside
    lw = rep.log_weights + torch.from_numpy(np.random.default_rng(3).normal(
        0.0, 1.0, 100).astype(np.float32))
    rep = rep.replace(log_weights=lw)
    der = tg.pf_dereplicate(torch.Generator().manual_seed(1), rep, 20,
                            layout=layout, method="sample")
    assert der.n_particles == 5
    assert _ancestry_ok(rep, der)
    lwn = lw.numpy()
    for i in range(5):
        blk = lwn[i * 20:(i + 1) * 20] if layout == "contiguous" \
            else lwn[i::5]
        par = int(der.parents[i])
        assert par in (range(i * 20, (i + 1) * 20) if layout == "contiguous"
                       else range(i, 100, 5))
        expect = np.log(np.sum(np.exp(blk - blk.max()))) + blk.max() \
            - math.log(20)
        np.testing.assert_allclose(float(der.log_weights[i]), expect,
                                   atol=1e-4)
    np.testing.assert_allclose(float(tg.log_ml_estimate(der)),
                               float(tg.log_ml_estimate(rep)), atol=1e-3)


def test_coalesce_matches_jax():
    # a replicated state: every particle has 4 exact duplicates
    jst, tst = _mot_pair(seed=5, n=25, masked=True)
    jrep = jg.pf_replicate(jst, 4, layout="interleaved")
    trep = tg.pf_replicate(tst, 4, layout="interleaved")
    jco, tco = jg.pf_coalesce(jrep), tg.pf_coalesce(trep)
    np.testing.assert_array_equal(tco.log_weights.numpy(),
                                  np.asarray(jco.log_weights))
    np.testing.assert_array_equal(tco.parents.numpy(),
                                  np.asarray(jco.parents))
    assert int(torch.isfinite(tco.log_weights).sum()) == 25
    np.testing.assert_allclose(
        float(torch.logsumexp(tco.log_weights, 0)) - math.log(25),
        float(tg.log_ml_estimate(tst)), atol=1e-4)
    # with y stored shared (dense observations) the shared entry is left
    # out of the key; the JAX package fails to reshape it to [N, -1]
    _, dense = _mot_pair(seed=5, n=25)
    co = tg.pf_coalesce(tg.pf_replicate(dense, 4))
    assert int(torch.isfinite(co.log_weights).sum()) == 25


@pytest.mark.parametrize("keys,alive", [
    (np.array([16777216, 16777217, 16777216, 16777217, 16777218, 16777218,
               16777216, 16777219], np.int32), 4),
    (np.array([1.0, np.nextafter(np.float32(1.0), np.float32(2.0)), 0.0,
               -0.0, 1.0, 0.0, 7.5, 7.5], np.float32), 4),
    (np.array([2**40, 2**40 + 1, 2**40, -1, -1, 3, 3, 2**40 + 1],
              np.int64), 4),
])
def test_coalesce_exact_keys(keys, alive):
    # int keys above 2**24 and float keys distinct only in low mantissa
    # bits stay apart; -0.0 merges with +0.0; 64-bit keys split exactly
    jst, tst = _mot_pair(seed=6, n=len(keys))
    co = tg.pf_coalesce(tst, by=lambda _tr: torch.from_numpy(keys))
    assert int(torch.isfinite(co.log_weights).sum()) == alive
    if keys.dtype != np.int64:
        jco = jg.pf_coalesce(jst, by=lambda _tr: jnp.asarray(keys))
        np.testing.assert_array_equal(co.log_weights.numpy(),
                                      np.asarray(jco.log_weights))


def test_introduce_folds_lml():
    _, tst = _mot_pair(seed=7)
    st = tg.pf_resample(torch.Generator().manual_seed(0), tst, "residual")
    lml_before = float(tg.log_ml_estimate(st))
    obs = tmot.mot_obs_dense(torch.from_numpy(_y(7)))
    out = tg.pf_introduce(torch.Generator().manual_seed(1), st, obs, 40)
    assert out.n_particles == N + 40
    assert float(out.log_ml_est) == 0.0
    np.testing.assert_allclose(out.log_weights[:N].numpy(), lml_before,
                               atol=1e-4)
    np.testing.assert_array_equal(out.parents.numpy(), np.arange(N + 40))
    # the old particles are untouched; the new ones are full traces
    assert _ancestry_ok(st, out.replace(
        traces=tree_take(out.traces, torch.arange(N)),
        parents=torch.arange(N, dtype=torch.int32)))
    assert torch.isfinite(out.log_weights).all()

    # a custom proposal (here one that proposes no choice) folds the same
    @tg.gen
    def nothing():
        return None
    nothing.batch_safe = True
    out = tg.pf_introduce(torch.Generator().manual_seed(2), st, obs, 4,
                          proposal=nothing)
    assert out.n_particles == N + 4
    np.testing.assert_allclose(out.log_weights[:N].numpy(), lml_before,
                               atol=1e-4)
    assert torch.isfinite(out.log_weights).all()


def test_resize_on_object_motion_and_dispatch():
    jst, tst = _om_pair()
    key = jr.key(9)
    e = np.array(jr.exponential(key, (61,), jnp.float32))
    _assert_same_state(jg.pf_resize(key, jst, 60, "multinomial"),
                       tg.pf_resize(None, tst, 60, "multinomial", e=e))
    with pytest.raises(ValueError, match="not recognized"):
        tg.pf_resize(None, tst, 60, "bogus")
    with pytest.raises(ValueError, match="cannot grow"):
        tg.pf_resize(None, tst, 2 * N, "optimal")
