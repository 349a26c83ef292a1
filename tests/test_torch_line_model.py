"""The line model (tests/fixtures.py, the reference's own test model: a
``@gen`` that calls an ``Unfold`` at ``"line"``) on the port.

- Mirrors of the JAX package's line-model tests (test_gfi.py,
  test_initialize.py, test_update.py, test_rejuvenate.py, the line-model
  cases of test_resample.py and test_resize.py, test_utils_statistics.py)
  with the same hand-checked weights and tolerances. The port's Unfold
  runs batched only, so a per-particle JAX test runs here under
  ``batched_interpretation(B)`` and each of the B particles is checked.
- Parity with JAX given the same numpy inputs, every site constrained so
  that no draw differs: generate, the full re-scan update with an
  overwrite, a trace alternating Extend and re-scan updates, regenerate's
  ``sel_old`` and ``_sel_logp``: float32 sums to atol 1e-5, the packed
  store's active rows and the int/bool choices bit-equal.
- Interop: a JAX line-model state carried across by ``state_from_numpy``
  and back by ``state_to_numpy``.
- The filter of the reference README on the line model at N=4000, by the
  full re-scan update (route A: ``UnknownChange``, systematic resampling)
  and by the call-site Extend (route B: ``Extend(1, at="line")``, residual
  resampling), each against the exact posterior over the slope and log Z.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from fixtures import (line_model as j_line_model,  # noqa: E402
                      line_choicemap as j_line_choicemap, lp_normal, lp_bern)
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import tree_take  # noqa: E402
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402

T_MAX = 10
B = 4          # particles of a batched run standing for a per-particle test


@tg.gen
def line_step(t, x, slope):
    x = x + 1.0
    outlier = tg.trace("outlier", tg.bernoulli(0.1))
    tg.trace("y", tg.normal(x * slope, torch.where(outlier, 10.0, 1.0)))
    return x


line_step.batch_safe = True
line_unfold = tg.Unfold(line_step, T_MAX)


@tg.gen
def line_model(n):
    slope = tg.trace("slope", tg.uniform_discrete(-2, 2))
    tg.trace("line", line_unfold, (n, slope.new_zeros((), dtype=torch.float32),
                                   slope.to(torch.float32)))
    return slope


line_model.batch_safe = True


def slope_choicemap(slope):
    return tg.choicemap(("slope", slope))


def line_choicemap(n, slope=0.0):
    return tg.choicemap(*[(("line", t, "y"), (t + 1) * slope)
                          for t in range(n)])


def outlier_choicemap(n, value):
    return tg.choicemap((("line", n - 1, "outlier"), value))


def G(seed):
    return torch.Generator().manual_seed(seed)


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# tests/test_gfi.py
# ---------------------------------------------------------------------------

def test_generate_weight_exact():
    obs = tg.choicemap((("line", 0, "y"), 0.0), (("line", 1, "y"), 0.0),
                       ("slope", 0))
    with tg.batched_interpretation(B):
        tr, w = line_model.generate(G(1), (2,), obs)
    outl = _np(tr.get_choices()[("line", "outlier")])      # [T, B]
    for i in range(B):
        expected = math.log(1 / 5) + sum(
            lp_normal(0.0, 0.0, 10.0 if outl[t, i] else 1.0)
            for t in range(2))
        np.testing.assert_allclose(float(w[i]), expected, atol=1e-4)


def test_update_extension_weight_exact():
    obs = tg.choicemap((("line", 0, "y"), 0.0), ("slope", 0))
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(1), (1,), obs)
        tr2, w, _, disc = tg.update(G(2), tr, (2,), (tg.UnknownChange(),),
                                    tg.choicemap((("line", 1, "y"), 0.5)))
    assert not bool(disc.total_mask_any())
    outl = _np(tr2.get_choices()[("line", 1, "outlier")])
    d = _np(tr2.score - tr.score)
    for i in range(B):
        s = 10.0 if outl[i] else 1.0
        np.testing.assert_allclose(float(w[i]), lp_normal(0.5, 0.0, s),
                                   atol=1e-4)
        np.testing.assert_allclose(
            d[i], lp_bern(bool(outl[i]), 0.1) + lp_normal(0.5, 0.0, s),
            atol=1e-4)


def test_update_overwrite_discard():
    obs = tg.choicemap((("line", 0, "y"), 0.0), ("slope", 0))
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(1), (1,), obs)
        tr2, w, _, disc = tg.update(G(2), tr, (1,), (tg.UnknownChange(),),
                                    tg.choicemap((("line", 0, "y"), 3.0)))
    assert bool(disc.total_mask_any())
    e = disc.resolve(("line", 0, "y"))
    assert e is not None and bool(e.mask)
    np.testing.assert_allclose(_np(e.value), 0.0, atol=1e-6)
    outl = _np(tr2.get_choices()[("line", 0, "outlier")])
    for i in range(B):
        s = 10.0 if outl[i] else 1.0
        np.testing.assert_allclose(
            float(w[i]), lp_normal(3.0, 0.0, s) - lp_normal(0.0, 0.0, s),
            atol=1e-4)


def test_update_shrink_discards_steps():
    obs = tg.choicemap((("line", 0, "y"), 0.0), (("line", 1, "y"), 1.0),
                       ("slope", 0))
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(1), (2,), obs)
        tr2, w, _, disc = tg.update(G(2), tr, (1,), (tg.UnknownChange(),),
                                    tg.EMPTY)
    e = disc.resolve(("line", 1, "y"))
    assert e is not None and bool(e.mask)
    np.testing.assert_allclose(_np(e.value), 1.0, atol=1e-6)
    assert not bool(disc.resolve(("line", 0, "y")).mask)
    # the weight drops step 1's choices: -lp(outlier_1) - lp(y_1)
    outl = _np(tr.get_choices()[("line", 1, "outlier")])
    for i in range(B):
        s = 10.0 if outl[i] else 1.0
        np.testing.assert_allclose(
            float(w[i]), -lp_bern(bool(outl[i]), 0.1)
            - lp_normal(1.0, 0.0, s), atol=1e-4)
    assert tr2.inner["subs"][("line",)].inner["t"] == 1


def test_regenerate_weight_exact():
    """Regenerating slope: weight = Σ_y [lp(y|new slope) − lp(y|old)]."""
    obs = tg.choicemap((("line", 0, "y"), 1.0), (("line", 1, "y"), 2.0))
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(3), (2,), obs)
    old_slope = _np(tr["slope"]).astype(np.float64)
    outl = _np(tr.get_choices()[("line", "outlier")])
    for rep in range(5):
        with tg.batched_interpretation(B):
            tr2, w = tg.regenerate(G(10 + rep), tr, (2,), (tg.NoChange(),),
                                   tg.select("slope"))
        new_slope = _np(tr2["slope"]).astype(np.float64)
        for i in range(B):
            expected = 0.0
            for t, y in enumerate([1.0, 2.0]):
                s = 10.0 if outl[t, i] else 1.0
                x = t + 1.0
                expected += (lp_normal(y, x * new_slope[i], s)
                             - lp_normal(y, x * old_slope[i], s))
            np.testing.assert_allclose(float(w[i]), expected, atol=1e-4)


def test_assess_matches_score():
    with tg.batched_interpretation(B):
        tr = line_model.simulate(G(5), (3,))
        _, score = tg.assess(line_model, (3,), tr.get_choices())
    np.testing.assert_allclose(_np(score), _np(tr.score), atol=1e-4)
    # the accessors of the GFI
    assert tg.get_score(tr) is tr.score and tg.get_args(tr) == (3,)
    assert tg.get_gen_fn(tr) is line_model
    assert torch.equal(tg.get_retval(tr), tr["slope"])
    assert set(tg.get_choices(tr).entries) == {
        ("slope",), ("line", "outlier"), ("line", "y")}
    sub = tr.inner["subs"][("line",)]
    np.testing.assert_array_equal(_np(line_unfold.active_mask(sub)),
                                  np.arange(T_MAX) < 3)


def test_assess_requires_every_active_step():
    with tg.batched_interpretation(B):
        with pytest.raises(ValueError, match="missing"):
            tg.assess(line_model, (3,), tg.choicemap(
                ("slope", torch.zeros(B, dtype=torch.int32)),
                (("line", 0, "y"), 0.0), (("line", 0, "outlier"), False)))


def test_propose_consistency():
    with tg.batched_interpretation(B):
        choices, score, _ = tg.propose(line_model, G(6), (2,))
        _, score2 = tg.assess(line_model, (2,), choices)
    np.testing.assert_allclose(_np(score), _np(score2), atol=1e-4)


def _masked_equal(ca, cb, atol):
    for k in ca.entries:
        ea, eb = ca.entries[k], cb.entries[k]
        ma, mb = ea.mask_array(), eb.mask_array()
        assert torch.equal(ma, mb)
        a = torch.where(ma, ea.value.double(), 0.0)
        b = torch.where(mb, eb.value.double(), 0.0)
        np.testing.assert_allclose(_np(a), _np(b), atol=atol)


def test_windowed_regenerate_matches_full():
    """window=k regenerate is exact when the selection only touches the
    last k active steps, also through the wrapping @gen model. With the
    selection keyed per step, the full re-scan draws at exactly the
    window's steps, so the two agree value for value; with the dense
    [T]-mask selection of the JAX test both weights are 0 (the selected
    sites have no downstream sites) and the unselected steps keep their
    values."""
    obs = tg.choicemap(*[(("line", t, "y"), 0.5 * t) for t in range(5)])
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(0), (5,), obs)
        sel = tg.select(*[("line", t, a) for t in (3, 4)
                          for a in ("outlier", "y")])
        full, wf = tg.regenerate(G(7), tr, (5,), (tg.NoChange(),), sel)
        fast, ww = tg.regenerate(G(7), tr, (5,), (tg.NoChange(),), sel,
                                 window=2)
        mask = (torch.arange(10) == 3) | (torch.arange(10) == 4)
        dense = tg.Selection({("line", "outlier"): mask,
                              ("line", "y"): mask})
        full_d, wfd = tg.regenerate(G(8), tr, (5,), (tg.NoChange(),), dense)
        fast_d, wwd = tg.regenerate(G(8), tr, (5,), (tg.NoChange(),), dense,
                                    window=2)
    np.testing.assert_allclose(_np(wf), _np(ww), atol=1e-4)
    np.testing.assert_allclose(_np(full.score), _np(fast.score), atol=1e-4)
    _masked_equal(full.get_choices(), fast.get_choices(), 1e-5)
    for w in (wf, wfd, wwd):
        np.testing.assert_allclose(_np(w), 0.0, atol=1e-4)
    for new in (full_d, fast_d):
        for a in ("outlier", "y"):
            np.testing.assert_array_equal(
                _np(new.get_choices()[("line", a)])[:3],
                _np(tr.get_choices()[("line", a)])[:3])


@pytest.mark.parametrize("at", [None, "line"])
def test_extend_through_nested_model(at):
    """Extend argdiffs reach the Unfold inside the wrapping @gen model and
    give the results of the full re-scan."""
    obs = tg.choicemap((("line", 2, "y"), 0.5))
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(0), (2,), line_choicemap(2))
        slow, ws, _, _ = tg.update(G(5), tr, (3,), (tg.UnknownChange(),),
                                   obs)
        before = line_unfold.steps_run
        fast, wf, _, _ = tg.update(G(5), tr, (3,), (tg.Extend(1, at=at),),
                                   obs)
    assert line_unfold.steps_run - before == 1
    np.testing.assert_allclose(_np(ws), _np(wf), atol=1e-5)
    np.testing.assert_allclose(_np(slow.score), _np(fast.score), atol=1e-5)
    _masked_equal(slow.get_choices(), fast.get_choices(), 1e-5)


def _sibling_model():
    @tg.gen
    def step(t, x):
        return tg.trace("x", tg.normal(x, 1.0))
    step.batch_safe = True
    grow, fixed = tg.Unfold(step, 6), tg.Unfold(step, 5)

    @tg.gen
    def model(n):
        tg.trace("grow", grow, (n, torch.zeros(())))
        tg.trace("fix", fixed, (5, torch.zeros(())))
    model.batch_safe = True
    return model


def test_extend_does_not_corrupt_sibling_unfolds():
    model = _sibling_model()
    obs = tg.choicemap((("grow", 2, "x"), 0.3))
    with tg.batched_interpretation(B):
        tr, _ = model.generate(G(0), (2,))
        fast, wf, _, _ = tg.update(G(1), tr, (3,),
                                   (tg.Extend(1, at="grow"),), obs)
        slow, ws, _, _ = tg.update(G(1), tr, (3,), (tg.UnknownChange(),),
                                   obs)
        noop, w0, _, _ = tg.update(G(2), fast, (3,), (tg.UnknownChange(),),
                                   tg.EMPTY)
        # a bare Extend with two sub-calls names none of them: both update
        # by their full re-scans
        bare, wb, _, _ = tg.update(G(1), tr, (3,), (tg.Extend(1),), obs)
    np.testing.assert_allclose(_np(wf), _np(ws), atol=1e-5)
    np.testing.assert_allclose(_np(fast.score), _np(slow.score), atol=1e-5)
    np.testing.assert_allclose(_np(wb), _np(ws), atol=1e-5)
    np.testing.assert_array_equal(_np(fast.get_choices()[("fix", "x")]),
                                  _np(tr.get_choices()[("fix", "x")]))
    np.testing.assert_allclose(_np(w0), 0.0, atol=1e-4)


def test_regenerate_structurally_new_site():
    """The old-absent site is sampled fresh, cancels in the weight, and
    the forced old pass scores nothing for it — drawing its placeholder
    from a fixed local generator, never from the caller's."""
    @tg.gen
    def m1():
        tg.trace("a", tg.normal(0.0, 1.0))

    @tg.gen
    def m2():
        tg.trace("a", tg.normal(0.0, 1.0))
        tg.trace("extra", tg.normal(2.0, 1.0))

    with tg.batched_interpretation(B):
        tr, _ = m1.generate(G(0), (), tg.choicemap(("a", 0.5)))
        gen = G(1)
        new_tr, sel_new, sel_old = m2._regenerate(gen, tr, (),
                                                  tg.select("a"))
        after = torch.rand(3, generator=gen)
        gen2 = G(1)
        m2._regenerate(gen2, tr, (), tg.select("a"), need_sel_old=False)
        assert torch.equal(after, torch.rand(3, generator=gen2))
    a_new = _np(new_tr.get_choices()["a"]).astype(np.float64)
    ex = _np(new_tr.get_choices()["extra"]).astype(np.float64)
    for i in range(B):
        lp_a, lp_ex = lp_normal(a_new[i], 0.0, 1.0), lp_normal(ex[i], 2.0, 1.0)
        np.testing.assert_allclose(float(new_tr.score[i]), lp_a + lp_ex,
                                   atol=1e-5)
        np.testing.assert_allclose(float(sel_new[i]), lp_a + lp_ex,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(sel_old), lp_normal(0.5, 0.0, 1.0),
                               atol=1e-5)


def test_structurally_new_sub_call():
    """A sub-call the old trace lacks: update generates it (its fresh
    draws count in logq), regenerate simulates it (cancelling), and the
    forced old pass scores nothing for it."""
    @tg.gen
    def inner(mu):
        return tg.trace("z", tg.normal(mu, 1.0))
    inner.batch_safe = True

    @tg.gen
    def m1():
        tg.trace("a", tg.normal(0.0, 1.0))

    @tg.gen
    def m2():
        a = tg.trace("a", tg.normal(0.0, 1.0))
        tg.trace("sub", inner, (a,))

    with tg.batched_interpretation(B):
        tr, _ = m1.generate(G(0), (), tg.choicemap(("a", 0.5)))
        up, w, _, _ = m2.update(G(1), tr, (), (), tg.EMPTY)
        rg, sel_new, sel_old = m2._regenerate(G(2), tr, (), tg.select("a"))
    np.testing.assert_allclose(_np(w), 0.0, atol=1e-5)
    z = _np(rg.get_choices()[("sub", "z")]).astype(np.float64)
    a = _np(rg.get_choices()["a"]).astype(np.float64)
    for i in range(B):
        lp = lp_normal(a[i], 0.0, 1.0) + lp_normal(z[i], a[i], 1.0)
        np.testing.assert_allclose(float(sel_new[i]), lp, atol=1e-5)
    np.testing.assert_allclose(_np(sel_old), lp_normal(0.5, 0.0, 1.0),
                               atol=1e-5)
    assert ("sub", "z") in up.get_choices().entries


def test_duplicate_address_across_sites_and_sub_calls():
    @tg.gen
    def bad(n):
        tg.trace("line", tg.normal(0.0, 1.0))
        tg.trace("line", line_unfold, (n, torch.zeros(()), torch.zeros(())))
    bad.batch_safe = True
    with tg.batched_interpretation(B):
        with pytest.raises(ValueError, match="duplicate address"):
            bad.simulate(G(0), (1,))
    with pytest.raises(TypeError):
        line_unfold(1, 0.0, 0.0)


# ---------------------------------------------------------------------------
# tests/test_initialize.py
# ---------------------------------------------------------------------------

@tg.gen
def line_propose(_s):
    tg.trace("slope", tg.uniform_discrete(0, 0))


line_propose.batch_safe = True


def make_outlier_propose(idxs, p=0.0):
    def body(*_):
        for i in idxs:
            tg.trace(("line", i, "outlier"), tg.bernoulli(p))
    fn = tg.gen(body)
    fn.batch_safe = True
    return fn


def test_initialize_default_proposal():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    slopes = tg.batched_choice(st, "slope")
    assert bool(torch.all((slopes >= -2) & (slopes <= 2)))
    np.testing.assert_allclose(_np(st.log_weights), 0.0, atol=1e-5)
    st = tg.pf_initialize(G(1), line_model, (1,), line_choicemap(1), 100)
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 0, "y"))),
                               0.0, atol=1e-6)
    st = tg.pf_initialize(G(2), line_model, (10,), line_choicemap(10), 100)
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 9, "y"))),
                               0.0, atol=1e-6)


def test_initialize_custom_proposal():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100,
                          proposal=line_propose, proposal_args=(0,))
    np.testing.assert_array_equal(_np(tg.batched_choice(st, "slope")), 0)
    np.testing.assert_allclose(_np(st.log_weights), math.log(1 / 5),
                               atol=1e-5)
    st = tg.pf_initialize(G(1), line_model, (1,), line_choicemap(1), 100,
                          proposal=make_outlier_propose([0]),
                          proposal_args=())
    assert not bool(torch.any(tg.batched_choice(st, ("line", 0, "outlier"))))
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 0, "y"))),
                               0.0, atol=1e-6)


def test_initialize_stratified():
    strata = [slope_choicemap(s) for s in range(-2, 3)]
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100,
                          strata=strata, layout="contiguous")
    np.testing.assert_allclose(_np(st.log_weights), 0.0, atol=1e-5)
    slopes = _np(tg.batched_choice(st, "slope"))
    for b, s in enumerate(range(-2, 3)):
        assert (slopes[b * 20:(b + 1) * 20] == s).all()
    st = tg.pf_initialize(G(1), line_model, (1,), line_choicemap(1), 100,
                          strata=strata, layout="interleaved")
    slopes = _np(tg.batched_choice(st, "slope"))
    for k, s in enumerate(range(-2, 3)):
        assert (slopes[k::5] == s).all()
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 0, "y"))),
                               0.0, atol=1e-6)


def test_initialize_stratified_custom_proposal():
    strata = [slope_choicemap(s) for s in range(-2, 3)]
    st = tg.pf_initialize(G(0), line_model, (1,), line_choicemap(1), 100,
                          proposal=make_outlier_propose([0]),
                          proposal_args=(), strata=strata,
                          layout="contiguous")
    slopes = _np(tg.batched_choice(st, "slope"))
    assert not _np(tg.batched_choice(st, ("line", 0, "outlier"))).any()
    lw = _np(st.log_weights)
    for b, s in enumerate(range(-2, 3)):
        blk = slice(b * 20, (b + 1) * 20)
        assert (slopes[blk] == s).all()
        np.testing.assert_allclose(
            lw[blk], lp_bern(False, 0.1) + lp_normal(0.0, s, 1.0),
            atol=1e-4)


def test_initialize_dynamic_flag_accepted():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 10, dynamic=True)
    assert st.n_particles == 10


# ---------------------------------------------------------------------------
# tests/test_update.py
# ---------------------------------------------------------------------------

def test_update_default_proposal():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = tg.pf_update(G(1), st, (1,), (tg.UnknownChange(),),
                      line_choicemap(1))
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 0, "y"))),
                               0.0, atol=1e-6)
    outl = _np(tg.batched_choice(st, ("line", 0, "outlier")))
    slopes = _np(tg.batched_choice(st, "slope")).astype(np.float64)
    expected = [lp_normal(0.0, s, 10.0 if o else 1.0)
                for o, s in zip(outl, slopes)]
    np.testing.assert_allclose(_np(st.log_weights), expected, atol=1e-4)


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
def test_update_stratified(layout):
    sel = ((lambda a, k: a[k * 50:(k + 1) * 50]) if layout == "contiguous"
           else (lambda a, k: a[k::2]))
    strata = [outlier_choicemap(1, False), outlier_choicemap(1, True)]
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = tg.pf_update(G(1), st, (1,), (tg.UnknownChange(),),
                      line_choicemap(1), strata=strata, layout=layout)
    outl = _np(tg.batched_choice(st, ("line", 0, "outlier")))
    slopes = _np(tg.batched_choice(st, "slope")).astype(np.float64)
    lw = _np(st.log_weights)
    for k, val in enumerate([False, True]):
        assert (sel(outl, k) == val).all()
        std = 10.0 if val else 1.0
        expected = [lp_bern(val, 0.1) + math.log(2) + lp_normal(0.0, s, std)
                    for s in sel(slopes, k)]
        np.testing.assert_allclose(sel(lw, k), expected, atol=1e-4)


def test_update_custom_proposal():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = tg.pf_update(G(1), st, (10,), (tg.UnknownChange(),),
                      line_choicemap(10),
                      proposal=make_outlier_propose(range(10)),
                      proposal_args=())
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 9, "y"))),
                               0.0, atol=1e-6)
    assert not bool(torch.any(tg.batched_choice(st, ("line", 9, "outlier"))))
    assert bool(torch.all(st.log_weights != 0))


def test_update_custom_proposal_stratified():
    strata = [outlier_choicemap(1, False), outlier_choicemap(1, True)]
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = tg.pf_update(G(1), st, (2,), (tg.UnknownChange(),),
                      line_choicemap(2), strata=strata,
                      proposal=make_outlier_propose([1]), proposal_args=())
    outl0 = _np(tg.batched_choice(st, ("line", 0, "outlier")))
    outl1 = _np(tg.batched_choice(st, ("line", 1, "outlier")))
    for k, val in enumerate([False, True]):
        assert (outl0[k::2] == val).all()
    assert not outl1.any()
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 1, "y"))),
                               0.0, atol=1e-6)


def test_update_fwd_bwd_proposals():
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 100)
    st = tg.pf_update(G(1), st, (10,), (tg.UnknownChange(),), tg.EMPTY,
                      proposal=make_outlier_propose(range(10), p=0.0),
                      proposal_args=(),
                      bwd_proposal=make_outlier_propose(range(10), p=0.1),
                      bwd_args=())
    assert not bool(torch.any(tg.batched_choice(st, ("line", 9, "outlier"))))
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 9, "y"))),
                               0.0, atol=1e-6)
    assert bool(torch.all(st.log_weights != 0))


def test_update_fwd_bwd_exact_weight():
    """Del Moral weight replacing outlier_0 with False via fwd Bern(0.0),
    bwd Bern(0.1): w = Δscore − 0 + lp_bern(old, 0.1)."""
    st = tg.pf_initialize(G(0), line_model, (1,), line_choicemap(1), 64)
    old_outl = _np(tg.batched_choice(st, ("line", 0, "outlier")))
    slopes = _np(tg.batched_choice(st, "slope")).astype(np.float64)
    old_lw = _np(st.log_weights)
    st = tg.pf_update(G(1), st, (1,), (tg.UnknownChange(),), tg.EMPTY,
                      proposal=make_outlier_propose([0], p=0.0),
                      proposal_args=(),
                      bwd_proposal=make_outlier_propose([0], p=0.1),
                      bwd_args=())
    new_lw = _np(st.log_weights)
    for i in range(64):
        o, s = bool(old_outl[i]), slopes[i]
        dscore = ((lp_bern(False, 0.1) + lp_normal(0, s, 1.0))
                  - (lp_bern(o, 0.1) + lp_normal(0, s, 10.0 if o else 1.0)))
        np.testing.assert_allclose(new_lw[i] - old_lw[i],
                                   dscore + lp_bern(o, 0.1), atol=1e-4)


def test_update_views():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = tg.pf_update(G(1), st[0:50], (10,), (tg.UnknownChange(),),
                      line_choicemap(10))
    st = tg.pf_update(G(2), st[50:100], (10,), (tg.UnknownChange(),),
                      line_choicemap(10),
                      proposal=make_outlier_propose(range(10)),
                      proposal_args=())
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 9, "y"))),
                               0.0, atol=1e-6)
    assert not _np(tg.batched_choice(st, ("line", 9, "outlier")))[50:].any()
    assert bool(torch.all(st.log_weights != 0))


def test_update_fwd_bwd_stratified():
    strata = [outlier_choicemap(1, False), outlier_choicemap(1, True)]
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = tg.pf_update(G(1), st, (2,), (tg.UnknownChange(),),
                      line_choicemap(2), strata=strata,
                      proposal=make_outlier_propose([1], p=0.0),
                      proposal_args=(),
                      bwd_proposal=make_outlier_propose([1], p=0.1),
                      bwd_args=())
    outl0 = _np(tg.batched_choice(st, ("line", 0, "outlier")))
    outl1 = _np(tg.batched_choice(st, ("line", 1, "outlier")))
    for k, val in enumerate([False, True]):
        assert (outl0[k::2] == val).all()
    assert not outl1.any()
    assert bool(torch.all(st.log_weights != 0))


def test_update_discard_check():
    """Re-constraining an observed step is a discard: pf_update raises
    unless check=False."""
    st = tg.pf_initialize(G(0), line_model, (3,), line_choicemap(3), 16)
    with pytest.raises(ValueError, match="updated or deleted"):
        tg.pf_update(G(1), st, (3,), None, line_choicemap(3, 1.0),
                     check=True)
    tg.pf_update(G(1), st, (3,), None, line_choicemap(3, 1.0), check=False)


# ---------------------------------------------------------------------------
# tests/test_rejuvenate.py
# ---------------------------------------------------------------------------

def test_move_reweight_selection_exact():
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(0), (1,), line_choicemap(1))
    slope = _np(tr["slope"]).astype(np.float64)
    out_old = _np(tr[("line", 0, "outlier")])
    sel = tg.select(("line", 0, "outlier"))
    for rep in range(6):
        with tg.batched_interpretation(B):
            new_tr, w = tg.move_reweight(G(rep + 1), tr, sel)
        out_new = _np(new_tr[("line", 0, "outlier")])
        for i in range(B):
            expected = (lp_normal(0, slope[i], 10.0 if out_new[i] else 1.0)
                        - lp_normal(0, slope[i],
                                    10.0 if out_old[i] else 1.0))
            np.testing.assert_allclose(float(w[i]), expected, atol=1e-4)


def test_move_reweight_proposal_exact():
    with tg.batched_interpretation(B):
        tr, _ = line_model.generate(G(0), (1,), line_choicemap(1))
    slope = _np(tr["slope"]).astype(np.float64)
    out_old = _np(tr[("line", 0, "outlier")])

    @tg.gen
    def outlier_propose(tr_, idx):
        tg.trace(("line", 0, "outlier"), tg.bernoulli(0.9))
    outlier_propose.batch_safe = True

    for rep in range(6):
        with tg.batched_interpretation(B):
            new_tr, w = tg.move_reweight(G(rep + 1), tr, outlier_propose,
                                         (0,))
        out_new = _np(new_tr[("line", 0, "outlier")])
        for i in range(B):
            o, n_ = bool(out_old[i]), bool(out_new[i])
            expected = (lp_bern(n_, 0.1) - lp_bern(o, 0.1)
                        + lp_normal(0, slope[i], 10.0 if n_ else 1.0)
                        - lp_normal(0, slope[i], 10.0 if o else 1.0)
                        - lp_bern(n_, 0.9) + lp_bern(o, 0.9))
            np.testing.assert_allclose(float(w[i]), expected, atol=1e-4)


def test_move_accept_only_accepted_change():
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10, 1.0),
                          100)
    old_slopes = _np(tg.batched_choice(st, "slope"))
    new_st, stats = tg.pf_move_accept(G(1), st, tg.mh,
                                      (tg.select("slope"),), 1,
                                      return_stats=True)
    accepts = _np(stats["accepts"])[:, 0].astype(bool)
    new_slopes = _np(tg.batched_choice(new_st, "slope"))
    assert (new_slopes[~accepts] == old_slopes[~accepts]).all()
    assert 0.0 <= float(stats["accept_rate"]) <= 1.0


def test_move_reweight_accumulates_weights():
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10, 1.0),
                          100)
    old_w = _np(st.log_weights)
    new_st, stats = tg.pf_move_reweight(G(1), st, tg.move_reweight,
                                        (tg.select("slope"),), 1,
                                        return_stats=True)
    rel = _np(stats["rel_weights"])[:, 0]
    np.testing.assert_allclose(_np(new_st.log_weights), old_w + rel,
                               atol=1e-3)


def test_rejuvenate_views():
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10, 1.0),
                          100)
    old_w_hi = _np(st.log_weights[50:])
    st = tg.pf_rejuvenate(G(1), st[0:50], tg.mh, (tg.select("slope"),), 1,
                          method="move")
    st2, stats = tg.pf_move_reweight(G(2), st[50:100], tg.move_reweight,
                                     (tg.select("slope"),), 1,
                                     return_stats=True)
    rel = _np(stats["rel_weights"])[:, 0]
    np.testing.assert_allclose(_np(st2.log_weights[50:]), old_w_hi + rel,
                               atol=1e-3)
    np.testing.assert_allclose(_np(st2.log_weights[:50]),
                               _np(st.log_weights[:50]), atol=1e-6)


def test_mh_stationarity_uniform_slope():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 500)
    for i in range(5):
        st = tg.pf_rejuvenate(G(i + 1), st, tg.mh, (tg.select("slope"),), 1)
    slopes = _np(tg.batched_choice(st, "slope"))
    counts = np.bincount(slopes + 2, minlength=5) / len(slopes)
    np.testing.assert_allclose(counts, 0.2, atol=0.08)


# ---------------------------------------------------------------------------
# tests/test_resample.py (line-model cases)
# ---------------------------------------------------------------------------

def _ancestry_ok(old, new):
    gathered = tree_take(old.traces, new.parents)
    return all(torch.equal(a, b) for a, b in
               zip(tree_leaves(gathered), tree_leaves(new.traces))
               if isinstance(a, torch.Tensor))


@pytest.mark.parametrize("method", ["multinomial", "residual", "stratified",
                                    "systematic"])
@pytest.mark.parametrize("use_priority", [False, True])
def test_resample_invariants(method, use_priority):
    p_fn = (lambda w: w / 2) if use_priority else None
    old = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 100)
    old_lml = float(torch.logsumexp(old.log_weights, 0) - math.log(100))
    new = tg.pf_resample(G(1), old, method, priority_fn=p_fn)
    assert _ancestry_ok(old, new)
    np.testing.assert_allclose(float(tg.log_ml_estimate(new)), old_lml,
                               atol=1e-4)
    if not use_priority:
        np.testing.assert_allclose(_np(new.log_weights), 0.0, atol=1e-5)


@pytest.mark.parametrize("method", ["residual", "stratified", "systematic"])
def test_resample_identity_on_equal_weights(method):
    old = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    new = tg.pf_resample(G(1), old, method)
    a = _np(tg.batched_choice(old, "slope"))
    b = _np(tg.batched_choice(new, "slope"))
    if method == "residual":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def test_residual_min_copies():
    old = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 100)
    w = _np(tg.get_norm_weights(old))
    new = tg.pf_resample(G(1), old, "residual")
    counts = np.bincount(_np(new.parents), minlength=100)
    assert (counts >= np.floor(w * 100).astype(int)).all()


def test_stratified_max_weight_copies():
    old = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 100)
    w = _np(tg.get_norm_weights(old))
    i = int(np.argmax(w))
    new = tg.pf_resample(G(1), old, "stratified", sort_particles=True)
    counts = np.bincount(_np(new.parents), minlength=100)
    assert counts[i] >= math.floor(w[i] * 100)


def test_resample_invalid_weights():
    st = tg.pf_initialize(G(0), line_model, (0,), slope_choicemap(-3), 100)
    assert bool(torch.all(torch.isinf(st.log_weights)))
    for method in ["multinomial", "residual", "stratified"]:
        with pytest.raises(FloatingPointError):
            tg.pf_resample(G(1), st, method, check=True)
        out = tg.pf_resample(G(1), st, method, check=False)
        np.testing.assert_allclose(_np(out.log_weights), 0.0, atol=1e-5)


@pytest.mark.parametrize("method", ["multinomial", "residual", "stratified"])
@pytest.mark.parametrize("use_priority", [False, True])
def test_blockwise_views(method, use_priority):
    p_fn = (lambda w: w / 2) if use_priority else None
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 100)
    old = st
    old_lml = float(torch.logsumexp(st.log_weights, 0) - math.log(100))
    for blk in (slice(0, 50), slice(50, 100)):
        sub_lml = float(tg.log_ml_estimate(st[blk]))
        st = tg.pf_resample(G(1 + blk.start), st[blk], method,
                            priority_fn=p_fn)
        np.testing.assert_allclose(float(tg.log_ml_estimate(st[blk])),
                                   sub_lml, atol=1e-4)
    np.testing.assert_allclose(float(tg.log_ml_estimate(st)), old_lml,
                               atol=1e-4)
    assert _ancestry_ok(old, st)


# ---------------------------------------------------------------------------
# tests/test_resize.py:204-248
# ---------------------------------------------------------------------------

def test_introduce_default():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 50)
    st = tg.pf_introduce(G(1), st, tg.EMPTY, 50)
    assert st.n_particles == 100
    slopes = _np(tg.batched_choice(st, "slope"))
    assert ((slopes >= -2) & (slopes <= 2)).all()
    np.testing.assert_allclose(_np(st.log_weights), 0.0, atol=1e-5)
    st = tg.pf_initialize(G(2), line_model, (10,), line_choicemap(10), 50)
    st = tg.pf_introduce(G(3), st, line_choicemap(10), 50)
    assert st.n_particles == 100
    np.testing.assert_allclose(_np(tg.batched_choice(st, ("line", 9, "y"))),
                               0.0, atol=1e-6)


def test_introduce_custom_proposal():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 50,
                          proposal=line_propose, proposal_args=(0,))
    st = tg.pf_introduce(G(1), st, tg.EMPTY, 50, proposal=line_propose,
                         proposal_args=(0,))
    assert st.n_particles == 100
    assert (_np(tg.batched_choice(st, "slope")) == 0).all()
    np.testing.assert_allclose(_np(st.log_weights), math.log(1 / 5),
                               atol=1e-4)


def test_introduce_folds_lml():
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 50)
    st = tg.pf_resample(G(1), st, "residual")
    lml_before = float(tg.log_ml_estimate(st))
    st = tg.pf_introduce(G(2), st, line_choicemap(10), 50)
    assert float(st.log_ml_est) == 0.0
    np.testing.assert_allclose(_np(st.log_weights[:50]), lml_before,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_utils_statistics.py:45-110
# ---------------------------------------------------------------------------

def test_ess_and_lml():
    st = tg.pf_initialize(G(0), line_model, (10,), line_choicemap(10), 100)
    lw = _np(st.log_weights).astype(np.float64)
    lnw = lw - (np.log(np.sum(np.exp(lw - lw.max()))) + lw.max())
    ess = 1.0 / np.sum(np.exp(lnw) ** 2)
    np.testing.assert_allclose(float(tg.effective_sample_size(st)), ess,
                               rtol=1e-4)
    np.testing.assert_allclose(float(tg.get_ess(st)), ess, rtol=1e-4)
    np.testing.assert_allclose(
        float(tg.log_ml_estimate(st)),
        float(torch.logsumexp(st.log_weights, 0)) - math.log(100), atol=1e-5)
    np.testing.assert_allclose(
        float(tg.log_ml_estimate(st[0:50])),
        float(torch.logsumexp(st.log_weights[:50], 0)) - math.log(50),
        atol=1e-5)


def test_sample_unweighted_traces():
    st = tg.pf_initialize(G(0), line_model, (0,), slope_choicemap(1), 20)
    traces = tg.sample_unweighted_traces(G(1), st, 7)
    slopes = traces.get_choices()["slope"]
    assert tuple(slopes.shape) in ((), (7,))
    assert bool(torch.all(slopes == 1))
    assert tuple(traces.get_choices()[("line", 0, "outlier")].shape) == (7,)


def test_mean_var_proportionmap():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 2000)
    m, v = float(tg.mean(st, "slope")), float(tg.var(st, "slope"))
    assert abs(m) < 0.15 and abs(v - 2.0) < 0.25
    pm = tg.proportionmap(st, "slope")
    assert set(pm) == {-2, -1, 0, 1, 2}
    np.testing.assert_allclose(sum(pm.values()), 1.0, atol=1e-5)
    assert all(abs(p - 0.2) < 0.1 for p in pm.values())
    np.testing.assert_allclose(float(tg.mean(st, "slope", lambda s: s * 2)),
                               2 * m, atol=1e-5)
    np.testing.assert_allclose(float(tg.var(st, "slope", lambda s: s * 2)),
                               4 * v, rtol=1e-4)
    assert set(tg.proportionmap(st, "slope", lambda s: abs(s))) == {0, 1, 2}


def test_weighted_mean_exact():
    st = tg.pf_initialize(G(0), line_model, (0,), tg.EMPTY, 100)
    st = st.replace(log_weights=torch.where(torch.arange(100) < 50, 0.0,
                                            -math.inf))
    slopes = _np(tg.batched_choice(st, "slope")).astype(np.float64)
    np.testing.assert_allclose(float(tg.mean(st, "slope")),
                               slopes[:50].mean(), atol=1e-4)


# ---------------------------------------------------------------------------
# Parity with JAX, every site constrained
# ---------------------------------------------------------------------------

NP = 6      # particles of the parity runs


def _inputs(seed, t=T_MAX):
    """Per-particle slopes, outliers and ys for every step."""
    rng = np.random.default_rng(seed)
    slope = rng.integers(-2, 3, NP).astype(np.int32)
    outl = rng.random((t, NP)) < 0.3
    y = ((np.arange(t)[:, None] + 1.0) * slope
         + rng.normal(size=(t, NP))).astype(np.float32)
    return slope, outl, y


def _dense(slope, outl, y, steps, with_slope=True):
    """The same constraints for both packages: slope, and the outlier and
    y of the given steps (int-keyed, each a per-particle [NP] value)."""
    jp = [] if not with_slope else [(("slope",), jg.Entry(jnp.asarray(slope),
                                                         True))]
    tp = [] if not with_slope else [(("slope",), tg.Entry(
        torch.from_numpy(slope), True))]
    for t in steps:
        for a, v in (("outlier", outl[t]), ("y", y[t])):
            jp.append((("line", t, a), jg.Entry(jnp.asarray(v), True)))
            tp.append((("line", t, a), tg.Entry(torch.from_numpy(v), True)))
    return jg.ChoiceMap(dict(jp)), tg.ChoiceMap(dict(tp))


def _same(jtr, ttr, t_active, w=None, jw=None):
    jsub, tsub = jtr.inner["subs"][("line",)], ttr.inner["subs"][("line",)]
    rows = t_active * tsub.inner["store"].layout.R
    np.testing.assert_array_equal(_np(tsub.inner["store"].mat)[:rows],
                                  np.asarray(jsub.inner["store"].mat)[:rows])
    np.testing.assert_array_equal(_np(tsub.inner["carry"]),
                                  np.asarray(jsub.inner["carry"]))
    assert tsub.inner["t"] == int(jsub.inner["t"]) == t_active
    np.testing.assert_array_equal(_np(ttr["slope"]), np.asarray(jtr["slope"]))
    np.testing.assert_allclose(_np(ttr.score), np.asarray(jtr.score),
                               atol=1e-5, rtol=0)
    if w is not None:
        np.testing.assert_allclose(_np(w), np.asarray(jw), atol=1e-5, rtol=0)


def _generate_both(seed, t):
    slope, outl, y = _inputs(seed)
    jcm, tcm = _dense(slope, outl, y, range(t))
    with jg.core.gfi.batched_interpretation(NP):
        jtr, jw = j_line_model.generate(jr.key(0), (t,), jcm)
    with tg.batched_interpretation(NP):
        ttr, tw = line_model.generate(G(0), (t,), tcm)
    return jtr, jw, ttr, tw


@pytest.mark.parametrize("t", [2, 5])
def test_generate_matches_jax(t):
    jtr, jw, ttr, tw = _generate_both(1, t)
    _same(jtr, ttr, t, tw, jw)


def test_full_update_with_overwrite_matches_jax():
    """The full re-scan update from t=2 to t=5, re-constraining steps 0-1
    (an overwrite: their old values are discarded)."""
    jtr, _, ttr, _ = _generate_both(2, 2)
    slope, outl, y = _inputs(3)
    jcm, tcm = _dense(slope, outl, y, range(5), with_slope=False)
    with jg.core.gfi.batched_interpretation(NP):
        jtr2, jw, _, jd = jg.update(jr.key(1), jtr, (5,),
                                    (jg.UnknownChange(),), jcm)
    with tg.batched_interpretation(NP):
        ttr2, tw, _, td = tg.update(G(1), ttr, (5,), (tg.UnknownChange(),),
                                    tcm)
    _same(jtr2, ttr2, 5, tw, jw)
    for a in ("outlier", "y"):
        for t in range(5):
            je, te = jd.resolve(("line", t, a)), td.resolve(("line", t, a))
            jm = np.broadcast_to(np.asarray(je.mask), (NP,))
            tm = np.broadcast_to(_np(te.mask), (NP,))
            np.testing.assert_array_equal(tm, jm)
            np.testing.assert_array_equal(
                np.where(tm, _np(te.value), 0),
                np.where(jm, np.asarray(je.value), 0))


def test_alternating_extend_and_rescan_matches_jax():
    """One trace grown by Extend and full re-scan updates in turn: each
    path reads and writes the layout the other left."""
    slope, outl, y = _inputs(4)
    jcm, tcm = _dense(slope, outl, y, range(1))
    with jg.core.gfi.batched_interpretation(NP):
        jtr, _ = j_line_model.generate(jr.key(0), (1,), jcm)
    with tg.batched_interpretation(NP):
        ttr, _ = line_model.generate(G(0), (1,), tcm)
    for t in range(1, 6):
        jcm, tcm = _dense(slope, outl, y, [t], with_slope=False)
        if t % 2:
            jd, td = (jg.Extend(1, at="line"),), (tg.Extend(1, at="line"),)
        else:
            jd, td = (jg.UnknownChange(),), (tg.UnknownChange(),)
        with jg.core.gfi.batched_interpretation(NP):
            jtr, jw, _, _ = jg.update(jr.key(t), jtr, (t + 1,), jd, jcm)
        with tg.batched_interpretation(NP):
            ttr, tw, _, _ = tg.update(G(t), ttr, (t + 1,), td, tcm)
        _same(jtr, ttr, t + 1, tw, jw)


def test_regenerate_sel_old_and_sel_logp_match_jax():
    """``_sel_logp`` forced on the old trace, and regenerate's ``sel_old``
    (the old slope's selected log-prob, recomputed under the OLD args):
    equal across the packages. The regenerate weight of each package is
    the hand formula on its own new slope."""
    jtr, _, ttr, _ = _generate_both(5, 4)
    jsel = jg.select("slope", ("line", 2, "y"))
    tsel = tg.select("slope", ("line", 2, "y"))
    with jg.core.gfi.batched_interpretation(NP):
        jrv, jso, jsc = j_line_model._sel_logp(jtr, (4,), jsel)
        _, jsn, jso2 = j_line_model._regenerate(jr.key(2), jtr, (4,),
                                                jg.select("slope"))
    with tg.batched_interpretation(NP):
        trv, tso, tsc = line_model._sel_logp(ttr, (4,), tsel)
        tnew, tsn, tso2 = line_model._regenerate(G(2), ttr, (4,),
                                                 tg.select("slope"))
        _, w = tg.regenerate(G(2), ttr, (4,), (tg.NoChange(),),
                             tg.select("slope"))
    np.testing.assert_array_equal(_np(trv), np.asarray(jrv))
    for a, b in ((tso, jso), (tsc, jsc), (tso2, jso2)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tsc), _np(ttr.score), atol=1e-5)
    slope, outl, y = _inputs(5)
    new = _np(tnew["slope"]).astype(np.float64)
    for i in range(NP):
        want = sum(lp_normal(y[t, i], (t + 1) * new[i],
                             10.0 if outl[t, i] else 1.0)
                   - lp_normal(y[t, i], (t + 1.0) * slope[i],
                               10.0 if outl[t, i] else 1.0)
                   for t in range(4))
        np.testing.assert_allclose(float(w[i]), want, atol=1e-4)


# ---------------------------------------------------------------------------
# Interop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 2])
def test_interop_round_trip(t):
    from genparticlefilters_tpu_torch.interop import (state_from_numpy,
                                                       state_to_numpy)
    jobs = j_line_choicemap(t, 1.0) if t else jg.choicemap()
    tobs = line_choicemap(t, 1.0) if t else tg.EMPTY
    jst = jg.pf_initialize(jr.key(0), j_line_model, (t,), jobs, 32)
    jleaves = jax.tree_util.tree_leaves(jst)
    arrays = [np.asarray(x) for x in jleaves]
    tst = state_from_numpy(line_model, arrays, (t,), tobs, device="cpu")
    for addr in ["slope"] + [("line", s, a) for s in range(t)
                             for a in ("outlier", "y")]:
        np.testing.assert_array_equal(_np(tg.batched_choice(tst, addr)),
                                      np.asarray(jg.batched_choice(jst,
                                                                   addr)))
    np.testing.assert_array_equal(_np(tst.log_weights),
                                  np.asarray(jst.log_weights))
    back = state_to_numpy(tst)
    assert len(back) == len(arrays) == 14
    for a, b, j in zip(back, arrays, jleaves):
        # Python int leaves (the lengths) come back as int32 scalars
        assert isinstance(j, int) or (a.dtype, a.shape) == (b.dtype, b.shape)
        np.testing.assert_array_equal(a, b)
    # the carried state runs on: a full re-scan update and a resample
    tst = tg.pf_update(G(1), tst, (t + 1,), (tg.UnknownChange(),),
                       tg.choicemap((("line", t, "y"), 0.5)))
    assert bool(torch.isfinite(tst.log_weights).all())
    tg.pf_resample(G(2), tst, "systematic")


# ---------------------------------------------------------------------------
# Entry points build on the card unless asked for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    from genparticlefilters_tpu_torch.models import object_motion as tom
    from genparticlefilters_tpu_torch.models import multi_object as tmot
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tom.init_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmot._x0(tmot.MOTParams())
    assert tom.init_state("cpu")[0].device.type == "cpu"
    assert tmot._x0(tmot.MOTParams(), "cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# The reference README's filter on the line model, against exact answers
# ---------------------------------------------------------------------------

def line_data(seed):
    """y_0..y_9 from the port's generate with slope constrained to 1."""
    with tg.batched_interpretation(1):
        tr, _ = line_model.generate(G(seed), (T_MAX,), slope_choicemap(1))
    return [float(v) for v in _np(tr.get_choices()[("line", "y")])[:, 0]]


def exact_line_posterior(y):
    """(P(slope = s | y) for s = -2..2, log Z), by enumeration in
    float64: p(s | y) ∝ (1/5) Π_t [0.9 N(y_t; (t+1)s, 1) + 0.1 N(y_t;
    (t+1)s, 10)]."""
    def lnorm(v, m, sd):
        return -0.5 * ((v - m) / sd) ** 2 - math.log(sd) \
            - 0.5 * math.log(2 * math.pi)
    lj = []
    for s in range(-2, 3):
        lp = math.log(1 / 5)
        for t, v in enumerate(y):
            a = math.log(0.9) + lnorm(v, (t + 1) * s, 1.0)
            b = math.log(0.1) + lnorm(v, (t + 1) * s, 10.0)
            lp += max(a, b) + math.log1p(math.exp(-abs(a - b)))
        lj.append(lp)
    lj = np.array(lj)
    m = lj.max()
    log_z = m + math.log(np.exp(lj - m).sum())
    return np.exp(lj - log_z), log_z


def line_filter(gen, y, n, route):
    """Route A: full re-scan updates (UnknownChange) and systematic
    resampling; route B: Extend(1, at="line") updates and residual
    resampling. Both rejuvenate the slope by MH with the full re-scan
    regenerate when the ESS falls below N/2."""
    method, diffs = (("systematic", (tg.UnknownChange(),)) if route == "A"
                     else ("residual", (tg.Extend(1, at="line"),)))
    st = tg.pf_initialize(gen, line_model, (0,), tg.EMPTY, n)
    for t in range(1, T_MAX + 1):
        if bool(tg.effective_sample_size(st) < n / 2):
            st = tg.pf_resample(gen, st, method, check=False)
            st = tg.pf_rejuvenate(gen, st, tg.mh, (tg.select("slope"),))
        st = tg.pf_update(gen, st, (t,), diffs,
                          tg.choicemap((("line", t - 1, "y"), y[t - 1])))
    return st


@pytest.mark.parametrize("route", ["A", "B"])
def test_line_filter_gate(route):
    """The 4o gate at N=4000: over 4 seeds the mean LML within
    6·stderr + 0.05 of log Z and every seed within 0.5 nat; P(slope = s)
    within 6·stderr + 0.02 of exact for every s."""
    y = line_data(7)
    post, log_z = exact_line_posterior(y)
    lmls, probs = [], []
    for seed in range(4):
        st = line_filter(G(100 + seed), y, 4000, route)
        lmls.append(float(tg.log_ml_estimate(st)))
        pm = tg.proportionmap(st, "slope")
        probs.append([pm.get(s, 0.0) for s in range(-2, 3)])
    lmls, probs = np.array(lmls), np.array(probs)
    se = lmls.std() / 2
    assert abs(lmls.mean() - log_z) < 6 * se + 0.05, (lmls, log_z)
    assert np.all(np.abs(lmls - log_z) < 0.5), (lmls, log_z)
    pse = probs.std(0) / 2
    assert np.all(np.abs(probs.mean(0) - post) < 6 * pse + 0.02), (
        probs.mean(0), post)


def test_outer_mask_matches_jax():
    """A line-model trace masked per particle (``mask_trace``): the Unfold
    keeps the mask as its outer mask. Its forced old pass scores only the
    present particles, its choices are masked [T, b], and a fully
    constrained re-scan update treats the absent particles' old steps as
    absent — all as in JAX."""
    jtr, _, ttr, _ = _generate_both(6, 3)
    m = np.array([True, False, True, True, False, False])
    jm, tm = j_line_model.mask_trace(jtr, jnp.asarray(m)), \
        line_model.mask_trace(ttr, torch.from_numpy(m))
    sub = tm.inner["subs"][("line",)]
    np.testing.assert_array_equal(
        _np(line_unfold.active_mask(sub)),
        m[:, None] & (np.arange(T_MAX) < 3)[None])
    sel_j, sel_t = jg.select("slope"), tg.select("slope")
    with jg.core.gfi.batched_interpretation(NP):
        _, jso, jsc = j_line_model._sel_logp(jm, (3,), sel_j)
    with tg.batched_interpretation(NP):
        _, tso, tsc = line_model._sel_logp(tm, (3,), sel_t)
    np.testing.assert_allclose(_np(tsc), np.asarray(jsc), atol=1e-5)
    np.testing.assert_allclose(_np(tso), np.asarray(jso), atol=1e-5)
    assert (_np(tsc)[~m] == 0).all()
    e = tm.get_choices().entries[("line", "y")]
    assert tuple(e.mask.shape) == (T_MAX, NP)
    np.testing.assert_array_equal(_np(e.mask)[:3], np.broadcast_to(m, (3, NP)))
    slope, outl, y = _inputs(7)
    jcm, tcm = _dense(slope, outl, y, range(4))
    with jg.core.gfi.batched_interpretation(NP):
        jtr2, jw, _, _ = jg.update(jr.key(1), jm, (4,), (jg.UnknownChange(),),
                                   jcm)
    with tg.batched_interpretation(NP):
        ttr2, tw, _, _ = tg.update(G(1), tm, (4,), (tg.UnknownChange(),),
                                   tcm)
    _same(jtr2, ttr2, 4, tw, jw)
    assert "outer_mask" not in ttr2.inner["subs"][("line",)].inner
