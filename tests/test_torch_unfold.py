"""Unfold of the port (genparticlefilters_tpu_torch/core/combinators.py)
against the JAX package, batched, on the object-motion step.

With every site constrained, generate and the Extend(1) update are
deterministic: the packed store ``mat`` and the carry must be bit-equal,
the score and weight agree to atol 1e-5 (float32 sin/log may differ by an
ulp between the frameworks). Also: the Extend path really runs only the
new step, and the windowed regenerate equals its delta form accepted
everywhere."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import object_motion as jom  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    object_motion as tom)

T, N = 6, 8


def _values(seed):
    """Choices drawn from the model's own dynamics (so every log-prob is
    O(1) and float32 sums stay well inside atol): one moving path with a
    few per-particle flips, positions 0.01 apart, one shared y_obs."""
    rng = np.random.default_rng(seed)
    base = rng.random(T) < 0.5
    mv = base[:, None] ^ (rng.random((T, N)) < 0.1)
    yv = np.zeros((T, N))
    prev = np.zeros(N)
    for t in range(T):
        prev = prev + np.where(mv[t], np.sin(t + 1.0), 0.0) \
            + 0.01 * rng.normal(size=N)
        yv[t] = prev
    yo = yv[:, 0] + 0.25 * rng.normal(size=T)
    return mv, yv.astype(np.float32), yo.astype(np.float32)


def _cms(mv, yv, yo):
    jcm = jg.ChoiceMap({("moving",): jg.Entry(jnp.asarray(mv), True),
                        ("y",): jg.Entry(jnp.asarray(yv), True),
                        ("y_obs",): jg.Entry(jnp.asarray(yo), True)})
    tcm = tg.ChoiceMap({("moving",): tg.Entry(torch.from_numpy(mv), True),
                        ("y",): tg.Entry(torch.from_numpy(yv), True),
                        ("y_obs",): tg.Entry(torch.from_numpy(yo), True)})
    return jcm, tcm


def _assert_same_trace(jtr, ttr):
    np.testing.assert_array_equal(ttr.inner["store"].mat.numpy(),
                                  np.asarray(jtr.inner["store"].mat))
    for tl, jl in zip(ttr.inner["carry"], jtr.inner["carry"]):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for tl, jl in zip(ttr.inner["store"].extras, jtr.inner["store"].extras):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ttr.inner["t"] == int(jtr.inner["t"])
    np.testing.assert_allclose(ttr.score.numpy(), np.asarray(jtr.score),
                               atol=1e-5, rtol=0)


def _generate_both(t_active, seed):
    mv, yv, yo = _values(seed)
    jcm, tcm = _cms(mv, yv, yo)
    with jg.core.gfi.batched_interpretation(N):
        jtr, jw = jom.make_object_motion(T).generate(
            jr.key(0), (t_active, jom.init_state()), jcm)
    tmodel = tom.make_object_motion(T)
    with tg.batched_interpretation(N):
        ttr, tw = tmodel.generate(torch.Generator().manual_seed(0),
                                  (t_active, tom.init_state("cpu")), tcm)
    return jtr, jw, ttr, tw, tmodel


@pytest.mark.parametrize("t_active", [2, T])
def test_generate_all_constrained_matches_jax(t_active):
    jtr, jw, ttr, tw, _ = _generate_both(t_active, seed=t_active)
    _assert_same_trace(jtr, ttr)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5,
                               rtol=0)


def test_update_extend_constrained_matches_jax():
    jtr, _, ttr, _, tmodel = _generate_both(2, seed=11)
    mv, yv, yo = _values(12)
    jcm, tcm = _cms(mv, yv, yo)
    with jg.core.gfi.batched_interpretation(N):
        jtr2, jw, _, _ = jtr.gen_fn.update(
            jr.key(1), jtr, (3, jom.init_state()),
            (jg.Extend(1), jg.NoChange()), jcm)
    before = tmodel.steps_run
    with tg.batched_interpretation(N):
        ttr2, tw, _, disc = ttr.gen_fn.update(
            torch.Generator().manual_seed(1), ttr, (3, tom.init_state("cpu")),
            (tg.Extend(1), tg.NoChange()), tcm)
    # the O(1) extension ran exactly the one new step, not all T
    assert tmodel.steps_run - before == 1
    assert not disc.entries
    _assert_same_trace(jtr2, ttr2)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5,
                               rtol=0)
    # the old trace is untouched (copy-on-write storage)
    _assert_same_trace(jtr, ttr)


def test_update_without_extend_is_not_ported():
    """Without Extend the update is the full re-scan: with every site
    constrained it equals the JAX package's on the active rows, the carry,
    the score and the weight; a broken Extend promise still raises."""
    jtr, _, ttr, _, tmodel = _generate_both(2, seed=13)
    jcm, tcm = _cms(*_values(14))
    with jg.core.gfi.batched_interpretation(N):
        jtr2, jw, _, _ = jtr.gen_fn.update(
            jr.key(1), jtr, (3, jom.init_state()),
            (jg.UnknownChange(), jg.NoChange()), jcm)
    before = tmodel.steps_run
    with tg.batched_interpretation(N):
        ttr2, tw, _, disc = ttr.gen_fn.update(
            torch.Generator(), ttr, (3, tom.init_state("cpu")),
            (tg.UnknownChange(), tg.NoChange()), tcm)
    assert tmodel.steps_run - before == 3
    rows = 3 * ttr2.inner["store"].layout.R
    np.testing.assert_array_equal(ttr2.inner["store"].mat[:rows].numpy(),
                                  np.asarray(jtr2.inner["store"].mat)[:rows])
    for tl, jl in zip(ttr2.inner["carry"], jtr2.inner["carry"]):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ttr2.score.numpy(), np.asarray(jtr2.score),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
    # the overwritten old y of steps 0 and 1 are discarded, step 2 was new
    e = disc.resolve(("y",))
    assert e.mask[:2].all() and not e.mask[2:].any()
    with tg.batched_interpretation(N):
        with pytest.raises(ValueError):
            ttr.gen_fn.update(torch.Generator(), ttr,
                              (4, tom.init_state("cpu")),
                              (tg.Extend(1), tg.NoChange()), tg.EMPTY)


def test_pf_update_takes_the_extend_path():
    y_obs = torch.linspace(0.0, 1.0, T)
    model = tom.make_object_motion(T)
    x0 = tom.init_state("cpu")
    obs = tom.obs_dense(y_obs)
    gen = torch.Generator().manual_seed(5)
    st = tg.pf_initialize(gen, model, (1, x0), obs, 64)
    assert model.steps_run == 1
    for t in range(1, T):
        st = tg.pf_update(gen, st, (t + 1, x0),
                          (tg.Extend(1), tg.NoChange()), obs)
        assert model.steps_run == t + 1
    assert st.traces.inner["t"] == T
    # y_obs stays ONE shared [T] row; per-particle leaves are [N]-wide
    assert tuple(st.traces.inner["store"].mat.shape) == (4 * T, 64)
    assert [tuple(e.shape) for e in st.traces.inner["store"].extras] == [
        (T,)]


def test_regenerate_window_equals_delta_accepted_everywhere():
    jtr, _, ttr, _, tmodel = _generate_both(4, seed=21)
    steps = torch.arange(T)
    m = (steps == 2) | (steps == 3)
    sel = tg.Selection({("moving",): m, ("y",): m})
    args = ttr.args
    nc = (tg.NoChange(), tg.NoChange())
    with tg.batched_interpretation(N):
        full, w = tg.regenerate(torch.Generator().manual_seed(9), ttr, args,
                                nc, sel, window=2)
        delta, wd = tmodel.regenerate_delta(
            torch.Generator().manual_seed(9), ttr, args, nc, sel, window=2)
        applied = tmodel.apply_regenerate_delta(
            ttr, delta, torch.ones(N, dtype=torch.bool))
        kept = tmodel.apply_regenerate_delta(
            ttr, delta, torch.zeros(N, dtype=torch.bool))
    np.testing.assert_allclose(w.numpy(), wd.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(full.inner["store"].mat, applied.inner["store"].mat)
    for a, b in zip(full.inner["carry"], applied.inner["carry"]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(full.score.numpy(), applied.score.numpy(),
                               atol=1e-5, rtol=0)
    # rejected everywhere: the old trace, bit for bit
    assert torch.equal(kept.inner["store"].mat, ttr.inner["store"].mat)
    assert torch.equal(kept.score, ttr.score)


def test_full_regenerate_of_a_shared_site_relays_the_store():
    """The full re-scan regenerate (window=None) of y_obs, which the
    dense observation stores shared, at one step: the new values carry the
    particle axis, so the store's layout is rebuilt — y_obs moves into
    ``mat``, as in the layout of the JAX package's full scan. The other
    choices of the active steps are unchanged and equal JAX's, and both
    weights are 0 (y_obs has no downstream site)."""
    jtr, _, ttr, _, tmodel = _generate_both(4, seed=31)
    steps = np.arange(T) == 2
    jsel = jg.Selection({("y_obs",): jnp.asarray(steps)})
    tsel = tg.Selection({("y_obs",): torch.from_numpy(steps)})
    with jg.core.gfi.batched_interpretation(N):
        jnew, jw = jg.regenerate(jr.key(2), jtr, (4, jom.init_state()),
                                 (jg.NoChange(), jg.NoChange()), jsel)
    with tg.batched_interpretation(N):
        tnew, tw = tg.regenerate(torch.Generator().manual_seed(2), ttr,
                                 (4, tom.init_state("cpu")),
                                 (tg.NoChange(), tg.NoChange()), tsel)
    np.testing.assert_allclose(tw.numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jw), 0.0, atol=1e-4)
    lo, jlo = tnew.inner["store"].layout, jnew.inner["store"].layout
    assert (lo.R, len(tnew.inner["store"].extras)) == (
        jlo.R, len(jnew.inner["store"].extras)) == (5, 0)
    assert ttr.inner["store"].layout.R == 4
    tc, jc, old = tnew.get_choices(), jnew.get_choices(), ttr.get_choices()
    for k in ("moving", "y"):
        np.testing.assert_array_equal(tc[k][:4].numpy(),
                                      np.asarray(jc[k])[:4])
    keep = [0, 1, 3]
    np.testing.assert_array_equal(
        tc["y_obs"][keep].numpy(),
        np.broadcast_to(old["y_obs"][keep].numpy()[:, None], (3, N)))
