"""Multinomial, residual, stratified and systematic resampling and
sub-state views (genparticlefilters_tpu_torch/smc/resample.py, state.py)
against the JAX package and against the invariants of
tests/test_resample.py.

Given the same draws (the ``e``/``v`` seams fed with JAX's own
``jr.exponential``/``jr.uniform`` values under the same key) and the same
brackets and queries ``(c, u)`` (or ``(det, rc, u)``), everything
downstream is float32 compares and integer work, so hit counts and parents
must be bit-equal to JAX's.

From the same weights and draws end to end, the port sums the cumulative
weights in float64 and JAX in float32, so a hit count (or a parent) may
differ
where a query lies within float32 spacing of a bracket edge. A tie is
identified in float64 as an edge (or query) with a query (or edge) within
1e-5 relative of it; every difference must be a tie, and differences stay
under 0.5% of n."""

import inspect
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from genparticlefilters_tpu.ops.fused_gather import (  # noqa: E402
    resample_gather_rows_u as jax_rows_u)
from genparticlefilters_tpu.smc import resample as jres  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import tree_take  # noqa
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    object_motion as tom)
from genparticlefilters_tpu_torch.ops.fused_gather import (  # noqa: E402
    resample_gather_split_u)
from genparticlefilters_tpu_torch.ops.merge_count import (  # noqa: E402
    merge_count)
from genparticlefilters_tpu_torch.smc import resample as tres  # noqa: E402
from genparticlefilters_tpu_torch.utils.weights import (  # noqa: E402
    logsumexp)

METHODS = ["multinomial", "residual", "stratified", "systematic"]
T = 6

_jit_mF = jax.jit(jres.multinomial_F)
_jit_rF = jax.jit(jres.residual_F)
_jit_merge = jax.jit(jres._merge_count)


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(n, seed):
    return np.random.default_rng(seed).dirichlet(
        np.full(n, 0.4)).astype(np.float32)


def _near(x, ref, rel=1e-5):
    """Per value of ``x``: does some value of ``ref`` lie within ``rel``
    (relative to |x|) of it (float64)?"""
    r = np.sort(np.asarray(ref, np.float64))
    x = np.asarray(x, np.float64)
    pos = np.searchsorted(r, x)
    lo = r[np.clip(pos - 1, 0, len(r) - 1)]
    hi = r[np.clip(pos, 0, len(r) - 1)]
    d = np.minimum(np.abs(x - lo), np.abs(x - hi))
    return d <= rel * np.maximum(np.abs(x), 1e-30)


def _assert_ties_only(got, ref, tie, n):
    bad = np.nonzero(np.asarray(got) != np.asarray(ref))[0]
    assert np.all(tie[bad]), bad[~tie[bad]]
    assert len(bad) <= 0.005 * n, len(bad)


def _sorted_u64(e):
    ce = np.cumsum(np.asarray(e, np.float64))
    return ce, ce[:-1] / ce[-1]


def _residual_parts(w, n):
    """JAX's residual arithmetic up to the uniforms: (det, n_res, resid)."""
    scaled = n * jnp.asarray(w)
    det = jnp.floor(scaled).astype(jnp.int32)
    return det, n - jnp.sum(det), scaled - det.astype(jnp.float32)


def _residual_u_jax(ce, n_res, n):
    j = jnp.arange(n, dtype=jnp.int32)
    return jnp.where(j < n_res, jnp.minimum(ce[:-1] / ce[n_res], 1.5), 1.75)


@pytest.mark.parametrize("n", [600, 4096, 100001])
def test_multinomial_matches_jax(n):
    w = _weights(n, n)
    key = jr.key(n + 1)
    e = np.array(jr.exponential(key, (n + 1,), jnp.float32))
    # given the same (c, u): the merge count (G4) and the float-bracket
    # gather (G2) are bit-equal to JAX's merge-count F and parents
    F_ref = np.asarray(_jit_mF(key, jnp.asarray(w)))
    ce = jres._sorted_uniforms_cum(key, n)
    c = jres._cumsum1(jnp.asarray(w))
    u = ce[:-1] / ce[-1]
    F = tres._pinned_F(merge_count(tres._normalized(_t(c)), _t(u)), n)
    np.testing.assert_array_equal(F.numpy(), F_ref)
    jc, ju = jres.multinomial_cu(key, jnp.asarray(w))
    par_ref = np.asarray(jres._F_to_parents(
        jres._pinned_F(_jit_merge(jc, ju), n), n))
    _, par = resample_gather_split_u([], _t(jc), _t(ju))
    np.testing.assert_array_equal(par.numpy(), par_ref)
    np.testing.assert_array_equal(
        tres._F_to_parents(F, n).numpy(),
        np.asarray(jres._F_to_parents(jnp.asarray(F_ref), n)))

    # end to end from the same weights and exponentials: ties only
    c64 = np.cumsum(w.astype(np.float64))
    c64 /= c64[-1]
    _, u64 = _sorted_u64(e)
    got = tres.multinomial_F(None, torch.from_numpy(w), e=e).numpy()
    assert got[-1] == n and np.all(np.diff(got) >= 0)
    _assert_ties_only(got, F_ref, _near(c64, u64), n)
    tc, tu = tres.multinomial_cu(None, torch.from_numpy(w), e=e)
    _, tpar = resample_gather_split_u([], tc, tu)
    _assert_ties_only(tpar.numpy(), par_ref, _near(u64, c64), n)


@pytest.mark.parametrize("n", [600, 4096, 100001])
def test_residual_matches_jax(n):
    w = _weights(n, n + 2)
    key = jr.key(n + 3)
    e = np.array(jr.exponential(key, (n + 1,), jnp.float32))
    det, n_res, resid = _residual_parts(w, n)
    ce = jres._sorted_uniforms_cum(key, n)
    u = _residual_u_jax(ce, n_res, n)
    # the port's uniforms from the same ce, read without a host sync
    np.testing.assert_array_equal(
        tres._residual_u(_t(ce), torch.tensor(int(n_res)), n).numpy(),
        np.asarray(u))
    tdet = _t(det)

    # residual_F (merge count, the sub-state path) given (det, rcum, u)
    F_ref = np.asarray(_jit_rF(key, jnp.asarray(w)))
    rcum = jres._cumsum1(resid)
    F = tres._pinned_F(torch.cumsum(tdet, 0, dtype=torch.int32)
                       + merge_count(tres._normalized(_t(rcum)), _t(u)), n)
    np.testing.assert_array_equal(F.numpy(), F_ref)

    # residual_F_fused (G2 role-swapped, the full-state path) given
    # (det, rc, u)
    Ff_ref = np.asarray(jres.residual_F_fused(key, jnp.asarray(w),
                                              interpret=True))
    rcf = jres._cummax1(jres._cumsum1(resid))
    rc = jnp.maximum(rcf / jnp.maximum(rcf[-1], 1e-37), 1e-30)
    _, G_ref = jax_rows_u(jnp.zeros((0, n), jnp.int32), u, rc,
                          interpret=True)
    _, G = resample_gather_split_u([], _t(u), _t(rc))
    np.testing.assert_array_equal(G.numpy(), np.asarray(G_ref))
    Ff = tres._pinned_F(torch.cumsum(tdet, 0, dtype=torch.int32) + G, n)
    np.testing.assert_array_equal(Ff.numpy(), Ff_ref)

    # end to end from the same weights and exponentials: ties only
    det64 = np.asarray(det)
    r64 = np.cumsum(np.asarray(resid, np.float64))
    r64 /= r64[-1]
    ce64, _ = _sorted_u64(e)
    k = int(n_res)
    u64 = ce64[:k] / ce64[k]
    tie = _near(r64, u64)
    for fn, ref in ((tres.residual_F, F_ref),
                    (tres.residual_F_fused, Ff_ref)):
        got = fn(None, torch.from_numpy(w), e=e).numpy()
        assert got[-1] == n and np.all(np.diff(got) >= 0)
        # the deterministic part is exact: at least ⌊n·w⌋ copies each
        assert np.all(np.diff(got, prepend=0) >= det64)
        _assert_ties_only(got, ref, tie, n)


@pytest.mark.parametrize("n", [600, 4096, 100001])
def test_stratified_matches_jax(n):
    w = _weights(n, n + 4)
    key = jr.key(n + 5)
    v = np.array(jr.uniform(key, (n,), jnp.float32))
    # stratified_F given (c, v)
    F_ref = np.asarray(jres.stratified_F(key, jnp.asarray(w)))
    c = n * jres._cumsum1(jnp.asarray(w))
    np.testing.assert_array_equal(
        tres._stratified_hits(_t(c), torch.from_numpy(v), n).numpy(), F_ref)
    # stratified_cu: the queries are bit-equal from the same v; given the
    # same (c, u) the G2 parents equal JAX's merge-count parents
    jc, ju = jres.stratified_cu(key, jnp.asarray(w))
    tc, tu = tres.stratified_cu(None, torch.from_numpy(w), v=v)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    par_ref = np.asarray(jres._F_to_parents(
        jres._pinned_F(_jit_merge(jc, ju), n), n))
    _, par = resample_gather_split_u([], _t(jc), _t(ju))
    np.testing.assert_array_equal(par.numpy(), par_ref)

    # end to end: ties only
    c64 = np.cumsum(w.astype(np.float64))
    q64 = (np.arange(n) + v.astype(np.float64)) / n
    got = tres.stratified_F(None, torch.from_numpy(w), v=v).numpy()
    assert got[-1] == n and np.all(np.diff(got) >= 0)
    _assert_ties_only(got, F_ref, _near(c64 / c64[-1], q64), n)
    _, tpar = resample_gather_split_u([], tc, tu)
    _assert_ties_only(tpar.numpy(), par_ref, _near(q64, c64 / c64[-1]), n)


@pytest.mark.parametrize("custom", [False, True])
def test_new_weights_sub_matches_jax(custom):
    rng = np.random.default_rng(11)
    n = 777
    lw = rng.normal(0.0, 3.0, size=n).astype(np.float32)
    lp = (0.5 * lw).astype(np.float32)
    parents = np.sort(rng.integers(0, n, size=n)).astype(np.int32)
    ref = np.asarray(jres._new_weights_sub(
        n, jnp.asarray(lw), jnp.asarray(lp), jnp.asarray(parents), custom))
    got = tres._new_weights_sub(n, _t(lw), _t(lp), _t(parents), custom)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_sorted_systematic_matches_jax():
    # fault: the port's systematic resampling had no sort_particles
    n = 300
    w = _weights(n, 5)
    lp = np.log(w)
    key = jr.key(6)
    u0 = np.float32(jr.uniform(key, (), jnp.float32))
    ref = np.asarray(jres.systematic_parents(
        key, jnp.asarray(w), log_priorities=jnp.asarray(lp),
        sort_particles=True))
    got = tres.systematic_parents(None, torch.from_numpy(w),
                                  log_priorities=torch.from_numpy(lp),
                                  sort_particles=True, u0=u0)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the heaviest particle's copies come first
    assert got[0].item() == int(np.argmax(w))
    assert "sort_particles" in inspect.signature(
        tres.pf_systematic_resample).parameters
    v = np.array(jr.uniform(key, (n,), jnp.float32))
    np.testing.assert_array_equal(
        tres.stratified_parents(None, torch.from_numpy(w), v=v).numpy(),
        np.asarray(jres.stratified_parents(key, jnp.asarray(w))))


# ---------------------------------------------------------------------------
# The invariants of tests/test_resample.py, on the port
# ---------------------------------------------------------------------------

def _om_state(n=100, observed=True, seed=0):
    """An object-motion state after 4 steps: weights from 4 observations
    (or all zero without them)."""
    y, _ = tom.synthesize_data(torch.Generator().manual_seed(42), T, 2)
    obs = tom.obs_dense(y) if observed else tg.ChoiceMap({})
    return tg.pf_initialize(torch.Generator().manual_seed(seed),
                            tom.make_object_motion(T),
                            (4, tom.init_state("cpu")), obs, n)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _ancestry_ok(old, new):
    return _same(tree_take(old.traces, new.parents), new.traces)


def _lml0(state):
    return float(logsumexp(state.log_weights) - math.log(state.n_particles))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("use_priority", [False, True])
def test_resample_invariants(method, use_priority):
    p_fn = (lambda w: w / 2) if use_priority else None
    old = _om_state()
    lw_before = old.log_weights.clone()
    new = tg.pf_resample(torch.Generator().manual_seed(1), old, method,
                         priority_fn=p_fn)
    assert _ancestry_ok(old, new)
    assert torch.equal(old.log_weights, lw_before)   # copy-on-write
    np.testing.assert_allclose(float(tg.log_ml_estimate(new)), _lml0(old),
                               atol=1e-4)
    if not use_priority:
        np.testing.assert_allclose(new.log_weights.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("method", ["residual", "stratified", "systematic"])
def test_resample_identity_on_equal_weights(method):
    old = _om_state(observed=False)
    assert bool(torch.all(old.log_weights == 0))
    new = tg.pf_resample(torch.Generator().manual_seed(1), old, method)
    a = tg.batched_choice(old, (2, "y")).numpy()
    b = tg.batched_choice(new, (2, "y")).numpy()
    if method == "residual":
        np.testing.assert_array_equal(a, b)
    else:   # stratified sorts by weight first: the multiset is kept
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_residual_min_copies():
    old = _om_state()
    w = tg.get_norm_weights(old).numpy()
    new = tg.pf_resample(torch.Generator().manual_seed(1), old, "residual")
    counts = np.bincount(new.parents.numpy(), minlength=100)
    assert (counts >= np.floor(w * 100).astype(int)).all()


def test_stratified_max_weight_copies():
    old = _om_state()
    w = tg.get_norm_weights(old).numpy()
    k = int(np.argmax(w))
    new = tg.pf_resample(torch.Generator().manual_seed(1), old, "stratified",
                         sort_particles=True)
    counts = np.bincount(new.parents.numpy(), minlength=100)
    assert counts[k] >= math.floor(w[k] * 100)


@pytest.mark.parametrize("method", METHODS)
def test_resample_invalid_weights(method):
    state = _om_state()
    state = state.replace(log_weights=torch.full((100,), -math.inf))
    with pytest.raises(FloatingPointError):
        tg.pf_resample(torch.Generator().manual_seed(1), state, method,
                       check=True)
    out = tg.pf_resample(torch.Generator().manual_seed(1), state, method,
                         check=False)
    np.testing.assert_allclose(out.log_weights.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("use_priority", [False, True])
def test_blockwise_views(method, use_priority):
    # per-block resampling keeps each block's LML and the global LML;
    # recorded parents are global indices inside their block
    p_fn = (lambda w: w / 2) if use_priority else None
    state = old = _om_state()
    for blk in (slice(0, 50), slice(50, 100)):
        sub = state[blk]
        assert isinstance(sub, tg.ParticleFilterView[1])
        sub_lml = float(tg.log_ml_estimate(sub))
        src_lw = state.log_weights.clone()
        state = tg.pf_resample(torch.Generator().manual_seed(blk.start),
                               sub, method, priority_fn=p_fn)
        assert torch.equal(sub.source.log_weights, src_lw)  # copy-on-write
        np.testing.assert_allclose(float(tg.log_ml_estimate(state[blk])),
                                   sub_lml, atol=1e-4)
        par = state.parents[blk]
        assert int(par.min()) >= blk.start and int(par.max()) < blk.stop
        assert torch.equal(state.log_ml_est, old.log_ml_est)
    np.testing.assert_allclose(float(tg.log_ml_estimate(state)), _lml0(old),
                               atol=1e-4)
    assert _ancestry_ok(old, state)


def test_sub_state_index_views():
    state = _om_state()
    idx = torch.tensor([3, 10, 50, 97], dtype=torch.int32)
    sub = state.view(idx)
    assert tg.num_particles(sub) == 4
    np.testing.assert_array_equal(tg.get_log_weights(sub).numpy(),
                                  state.log_weights.numpy()[[3, 10, 50, 97]])
    np.testing.assert_array_equal(tg.get_parents(sub).numpy(),
                                  [3, 10, 50, 97])
    np.testing.assert_allclose(
        tg.get_log_norm_weights(sub).exp().sum().item(), 1.0, atol=1e-6)
    new = tg.pf_resample(torch.Generator().manual_seed(3), sub, "residual")
    untouched = torch.ones(100, dtype=torch.bool)
    untouched[idx.long()] = False
    assert torch.equal(new.parents[untouched],
                       state.parents[untouched])
    assert set(new.parents[idx.long()].tolist()) <= {3, 10, 50, 97}
    assert _ancestry_ok(state, new)


@pytest.mark.parametrize("fn", [tres.multinomial_F, tres.residual_F,
                                tres.residual_F_fused])
def test_F_monotone_on_degenerate_weights(fn):
    # 2^18+13 particles, nearly all mass on one: where a reassociating
    # scan broke monotonicity on the TPU; the cummax guards keep hit
    # counts and parents monotone
    n = 2**18 + 13
    w = np.full(n, 1e-12, np.float64)
    w[n // 3] = 1.0
    w = (w / w.sum()).astype(np.float32)
    F = fn(torch.Generator().manual_seed(0), torch.from_numpy(w))
    assert F[-1].item() == n and bool(torch.all(F[1:] >= F[:-1]))
    parents = tres._F_to_parents(F, n)
    assert bool(torch.all(parents[1:] >= parents[:-1]))
    assert parents.min().item() >= 0 and parents.max().item() < n
    c, u = tres.multinomial_cu(torch.Generator().manual_seed(1),
                               torch.from_numpy(w))
    assert bool(torch.all(c[1:] >= c[:-1])) and bool(torch.all(u[1:] >= u[:-1]))
    assert float(u.min()) >= 1e-37


def _cu_parents(cu_fn):
    def fn(g, w):
        return resample_gather_split_u([], *cu_fn(g, w))[1]
    return fn


@pytest.mark.parametrize("parent_fn", [
    lambda g, w: tres.multinomial_parents(g, w),
    lambda g, w: tres.residual_parents(g, w),
    lambda g, w: tres.stratified_parents(g, w),
    lambda g, w: tres.systematic_parents(g, w),
    _cu_parents(tres.multinomial_cu),
    _cu_parents(tres.stratified_cu),
    lambda g, w: tres._F_to_parents(tres.residual_F_fused(g, w), 32),
], ids=["multinomial", "residual", "stratified", "systematic",
        "multinomial_cu", "stratified_cu", "residual_F_fused"])
def test_resampling_unbiased_counts(parent_fn):
    """E[offspring counts] = n·w for every method and route."""
    n, reps = 32, 400
    w = np.random.default_rng(5).dirichlet(np.ones(n))
    tw = torch.from_numpy(w.astype(np.float32))
    total = np.zeros(n)
    for i in range(reps):
        p = parent_fn(torch.Generator().manual_seed(i), tw).numpy()
        total += np.bincount(p, minlength=n)
    avg = total / reps
    stderr = np.sqrt(n * w * (1 - w) / reps) + 1e-3
    assert np.all(np.abs(avg - n * w) < 6 * stderr + 0.05), (
        np.abs(avg - n * w) / stderr)


@pytest.mark.parametrize("parent_fn", [
    lambda g, w: tres.multinomial_parents(g, w),
    lambda g, w: tres.residual_parents(g, w),
    lambda g, w: tres.stratified_parents(g, w),
    lambda g, w: tres.systematic_parents(g, w),
    _cu_parents(tres.multinomial_cu),
    _cu_parents(tres.stratified_cu),
    lambda g, w: tres._F_to_parents(tres.residual_F_fused(g, w),
                                    w.shape[0]),
], ids=["multinomial", "residual", "stratified", "systematic",
        "multinomial_cu", "stratified_cu", "residual_F_fused"])
def test_zero_weight_particles_are_never_picked(parent_fn):
    """Nine in ten weights exactly 0 at N=100K: no method may pick one.
    (On the card a float32 scan did, where its blocks join: the cumulative
    weights are summed in float64.)"""
    n = 100_000
    rng = np.random.default_rng(6)
    w = rng.gamma(0.3, size=n) * (rng.random(n) < 0.1)
    tw = torch.from_numpy((w / w.sum()).astype(np.float32))
    for seed in range(3):
        p = parent_fn(torch.Generator().manual_seed(seed), tw).long()
        assert bool((tw[p] > 0).all())


def test_sample_unweighted_traces():
    state = _om_state()
    lw = torch.full((100,), -math.inf)
    lw[17] = 0.0
    tr = tg.sample_unweighted_traces(torch.Generator().manual_seed(0),
                                     state.replace(log_weights=lw), 9)
    assert tr.score.shape == (9,)
    assert torch.equal(tr.score, state.traces.score[17].expand(9))
    tr = tg.sample_unweighted_traces(torch.Generator().manual_seed(1),
                                     state, 64)
    assert set(tr.score.tolist()) <= set(state.traces.score.tolist())


def test_defaults_match_the_jax_package():
    # faults: the port defaulted to "systematic" in both places
    assert inspect.signature(tres.pf_resample).parameters[
        "method"].default == "multinomial"
    assert inspect.signature(jres.pf_resample).parameters[
        "method"].default == "multinomial"
    assert inspect.signature(tom.object_motion_filter).parameters[
        "resample_method"].default == "residual"
    state = _om_state()
    a = tg.pf_resample(torch.Generator().manual_seed(4), state)
    b = tg.pf_multinomial_resample(torch.Generator().manual_seed(4), state)
    assert torch.equal(a.parents, b.parents)
    y, _ = tom.synthesize_data(torch.Generator().manual_seed(42), T, 2)
    s1 = tom.object_motion_filter(torch.Generator().manual_seed(5), y, 200,
                                  T)
    s2 = tom.object_motion_filter(torch.Generator().manual_seed(5), y, 200,
                                  T, resample_method="residual")
    assert torch.equal(s1.parents, s2.parents)
    assert torch.equal(s1.log_weights, s2.log_weights)
