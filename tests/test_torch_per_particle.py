"""The per-particle interpretation of the port (``vmap_gfi`` on
``torch.func.vmap``), which every model, proposal or translator not marked
``batch_safe`` runs, and the batched-layout guard.

- Deterministic parts against the JAX package's vmapped path on the same
  numpy inputs (atol 1e-5): fully constrained ``generate`` weights, the
  kept-old rescoring update of a carried-over vmapped state, fully
  constrained ``MapCombinator`` weights; and the leaf shapes and dtypes of
  a state built per particle against JAX's vmapped one (the line model,
  the plate, an SMCP³ translator).
- Port per-particle against port batched: a map draws what the batched
  interpretation draws (``randomness="different"`` turns a per-particle
  draw into one ``[N]`` draw), so every verb — generate, the Unfold's
  Extend, full re-scans, windows and ``assess``, every ``mh`` and
  ``move_reweight`` form, strata, translators, ``pf_introduce`` — gives
  the batched path's weights; a state built by one path takes the other's
  update.
- Ground truths: the slope posterior against enumeration, MH
  stationarity, E[exp LML] against the Kalman filter, and a model only
  the per-particle path reads right (``mu[k]`` of an ``mvnormal_diag``)
  against its conjugate posterior.
- The guard: a shared value whose leading dim equals N raises at N=64,
  runs at N=32, and ``use_check_batched_layout(False)`` silences it; a
  guarded run draws and returns what an unguarded one does.
- Checks that read the device (discards, observations, round trips) wait
  until the map returns, and no op on these paths falls back to vmap's
  per-element loop (the fallback warning is an error here).
"""

import copy
import itertools
import math
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from fixtures import (line_model as j_line_model, lp_normal,  # noqa: E402
                      line_choicemap as j_line_choicemap)
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch import config as tconfig  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import (  # noqa: E402
    vmap_gfi, check_batched_layout, BOUNDARY)
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.interop import state_from_numpy  # noqa
from genparticlefilters_tpu_torch.models import object_motion as tom  # noqa
from test_torch_line_model import (line_model, line_choicemap,  # noqa: E402
                                   slope_choicemap, G)
from test_torch_rejuvenate import FORMS, TMODEL, _state  # noqa: E402


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    """An op without a batching rule runs vmap's per-element loop: fail."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _unmarked(gf):
    out = copy.copy(gf)
    out.batch_safe = False
    return out


def _retyped(state, gen_fn):
    """The state with its traces' generative function swapped (a marked
    and an unmarked copy of one model share every trace)."""
    tr = state.traces
    return state.replace(traces=tg.Trace(gen_fn, tr.args, tr.retval,
                                         tr.score, tr.inner))


def _kind(shape, dtype):
    """(shape, dtype name) of a leaf, a 0-d integer (a Python int in one
    package, an int32 array in the other: the lockstep length) as "int"."""
    name = str(dtype).replace("torch.", "")
    if shape == () and name.startswith(("int", "uint")):
        name = "int"
    return shape, name


def _shapes(tree):
    return [_kind(tuple(np.shape(x)), getattr(x, "dtype", np.asarray(x).dtype))
            for x in tree_leaves(tree)]


def _jshapes(tree):
    return [_kind(tuple(np.shape(x)), np.asarray(x).dtype)
            for x in jax.tree_util.tree_leaves(tree)]


T_LINE = 5
UNMARKED_LINE = _unmarked(line_model)
J_UNMARKED_LINE = _unmarked(j_line_model)


def _full_line_cm(lib, n):
    cm = (j_line_choicemap if lib is jg else line_choicemap)(n).merge(
        lib.choicemap(("slope", 1)))
    return cm.merge(lib.choicemap(*[(("line", t, "outlier"), t % 2 == 1)
                                    for t in range(n)]))


# ---------------------------------------------------------------------------
# Deterministic parts against the JAX package's vmapped path
# ---------------------------------------------------------------------------

def test_fully_constrained_generate_matches_jax_vmapped():
    """Every site constrained: no draw, so the per-particle weights are
    JAX's, and the state has JAX's vmapped leaf shapes and dtypes (the
    observations stored per particle, the lockstep length shared)."""
    jst = jg.pf_initialize(jr.key(0), J_UNMARKED_LINE, (T_LINE,),
                           _full_line_cm(jg, T_LINE), 16)
    tst = tg.pf_initialize(G(0), UNMARKED_LINE, (T_LINE,),
                           _full_line_cm(tg, T_LINE), 16)
    np.testing.assert_allclose(tst.log_weights.numpy(),
                               np.asarray(jst.log_weights), atol=1e-5)
    assert _shapes(tst) == _jshapes(jst)
    store = tst.traces.inner["subs"][("line",)].inner["store"]
    assert store.mat.is_contiguous() and store.mat.shape[1] == 16


def test_rescore_kept_old_update_matches_jax():
    """An args-change update with no constraints keeps the old values and
    rescores them: a JAX vmapped tempered state carried into the port
    takes the same weights per particle and batched."""
    from genparticlefilters_tpu.models.tempered import make_tempered_model
    from genparticlefilters_tpu_torch.models.tempered import (
        make_tempered_model as t_make)
    jmodel = _unmarked(make_tempered_model())
    jst = jg.pf_initialize(jr.key(0), jmodel, (jnp.float32(0.3),),
                           jg.choicemap(), 64)
    jup = jg.pf_update(jr.key(1), jst, (jnp.float32(0.7),),
                       (jg.UnknownChange(),),
                       jg.choicemap(), check=False)
    tmodel = t_make()
    leaves = [np.array(x) for x in jax.tree_util.tree_flatten(jst)[0]]
    tst = state_from_numpy(_unmarked(tmodel), leaves, (torch.tensor(0.3),),
                           tg.EMPTY, device="cpu")
    for st in (tst, _retyped(tst, tmodel)):
        up = tg.pf_update(G(1), st, (torch.tensor(0.7),),
                          (tg.UnknownChange(),), tg.EMPTY, check=False)
        np.testing.assert_allclose(up.log_weights.numpy(),
                                   np.asarray(jup.log_weights), atol=1e-5)


def _plate(lib, ex):
    @lib.gen
    def unit(t, mu):
        x = lib.trace("x", lib.normal(mu, 1.0))
        lib.trace("y", lib.normal(x, 0.5))
        return x

    unit.batch_safe = True
    plate = lib.MapCombinator(unit, 8)

    @lib.gen
    def model():
        lib.trace("p", plate, (ex.arange(8, dtype=ex.int32), ex.zeros(8)))
        return 0.0

    model.batch_safe = True
    return model


def test_map_layout_and_constrained_weights_match_jax():
    """Per particle the plate's constrained observation is stored [N, n]
    (JAX's vmapped layout), batched it is shared [n]; fully constrained,
    the weights are JAX's."""
    jmodel, tmodel = _plate(jg, jnp), _plate(tg, torch)
    ys, xs = np.linspace(-1, 1, 8), np.linspace(-0.5, 0.5, 8)

    def obs(lib, ex, both):
        e = {("p", "y"): lib.Entry(ex.asarray(ys, dtype=ex.float32), True)}
        if both:
            e[("p", "x")] = lib.Entry(ex.asarray(xs, dtype=ex.float32), True)
        return lib.ChoiceMap(e)
    tst = tg.pf_initialize(G(0), _unmarked(tmodel), (), obs(tg, torch, False),
                           32)
    bst = tg.pf_initialize(G(0), tmodel, (), obs(tg, torch, False), 32)
    jst = jg.pf_initialize(jr.key(0), _unmarked(jmodel), (),
                           obs(jg, jnp, False), 32)
    assert tuple(tst.traces.get_choices()[("p", "y")].shape) == (32, 8)
    assert tuple(bst.traces.get_choices()[("p", "y")].shape) == (8,)
    assert _shapes(tst) == _jshapes(jst)
    np.testing.assert_allclose(tst.log_weights.numpy(),
                               bst.log_weights.numpy(), atol=1e-6)
    tw = tg.pf_initialize(G(3), _unmarked(tmodel), (), obs(tg, torch, True),
                          4).log_weights
    jw = jg.pf_initialize(jr.key(3), _unmarked(jmodel), (),
                          obs(jg, jnp, True), 4).log_weights
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)


def _smcp3(lib, ex, model_mod):
    model = model_mod.make_tempered_model()

    @lib.gen
    def fwd(tr):
        lib.trace("eps", lib.normal(0.0, 0.25))

    def shift(prev, f):
        eps, x = f[("eps",)], prev[("x",)]
        return (lib.ChoiceMap({("x",): lib.Entry(x + eps, True)}),
                lib.ChoiceMap({("eps",): lib.Entry(-eps, True)}))
    return model, fwd, lib.TraceTransform(shift, inverse_fn=shift)


def test_translator_per_particle_matches_jax_structure():
    """An SMCP³ step whose proposals are unmarked runs per particle: the
    state has JAX's vmapped leaf shapes, and the weights those of the
    batched translator drawing the same numbers."""
    from genparticlefilters_tpu.models import tempered as jt
    from genparticlefilters_tpu_torch.models import tempered as tt
    jm, jf, jtf = _smcp3(jg, jnp, jt)
    tm, tf, ttf = _smcp3(tg, torch, tt)
    jst = jg.pf_initialize(jr.key(4), _unmarked(jm), (jnp.float32(0.3),),
                           jg.choicemap(), 64)
    jout = jg.pf_update(jr.key(9), jst, translator=jg.UpdatingTraceTranslator(
        p_new_args=(jnp.float32(0.8),), p_argdiffs=(jg.UnknownChange(),),
        q_forward=_unmarked(jf), q_backward=_unmarked(jf), transform=jtf),
        check=False)
    st = tg.pf_initialize(G(4), tm, (torch.tensor(0.3),), tg.EMPTY, 64)
    outs = []
    for q in (tf, _unmarked(tf)):
        q.batch_safe = q is tf
        tr = tg.UpdatingTraceTranslator(
            p_new_args=(torch.tensor(0.8),), p_argdiffs=(tg.UnknownChange(),),
            q_forward=q, q_backward=q, transform=ttf)
        outs.append(tg.pf_update(G(9), st, translator=tr, check=True))
    np.testing.assert_allclose(outs[1].log_weights.numpy(),
                               outs[0].log_weights.numpy(), atol=1e-6)
    assert _shapes(outs[1]) == _jshapes(jout)


def test_jax_vmapped_line_state_takes_both_updates():
    """A JAX vmapped line-model state carried over by ``state_from_numpy``
    takes a per-particle and a batched port update, both fully
    constrained, with JAX's weights."""
    jst = jg.pf_initialize(jr.key(0), J_UNMARKED_LINE, (2,),
                           _full_line_cm(jg, 2), 32)
    leaves = [np.array(x) for x in jax.tree_util.tree_flatten(jst)[0]]
    tst = state_from_numpy(UNMARKED_LINE, leaves, (2,),
                           _full_line_cm(tg, 2), device="cpu")
    jcm = jg.choicemap((("line", 2, "y"), 2.5), (("line", 2, "outlier"),
                                                   False))
    tcm = tg.choicemap((("line", 2, "y"), 2.5), (("line", 2, "outlier"),
                                                   False))
    jup = jg.pf_update(jr.key(1), jst, (3,), (jg.UnknownChange(),), jcm)
    for st in (tst, _retyped(tst, line_model)):
        up = tg.pf_update(G(1), st, (3,), (tg.UnknownChange(),), tcm)
        np.testing.assert_allclose(up.log_weights.numpy(),
                                   np.asarray(jup.log_weights), atol=1e-5)
        np.testing.assert_array_equal(
            tg.batched_choice(up, ("line", 2, "y")).numpy(),
            np.full(32, 2.5, np.float32))


# ---------------------------------------------------------------------------
# Port per-particle against port batched
# ---------------------------------------------------------------------------

def _om_filter(gen, y_obs, n, marked, method="systematic", t_max=8):
    model = tom.make_object_motion(t_max)
    model.step.batch_safe = marked
    x0 = tom.init_state("cpu")
    obs = tom.obs_dense(y_obs)
    st = tg.pf_initialize(gen, model, (1, x0), obs, n)
    steps = torch.arange(t_max)
    for t in range(1, t_max):
        if bool(tg.effective_sample_size(st) < 0.5 * n):
            st = tg.pf_resample(gen, st, method, check=False)
            m = (steps == t - 1) | (steps == t)
            st = tg.pf_rejuvenate(gen, st, tg.mh, (tg.Selection(
                {("moving",): m, ("y",): m}),), window=2)
        st = tg.pf_update(gen, st, (t + 1, x0), (tg.Extend(1), tg.NoChange()),
                          obs, check=False)
    return st


@pytest.mark.parametrize("method", ["systematic", "residual"])
def test_object_motion_per_particle_draws_what_batched_draws(method):
    """The headline filter with an unmarked step body (per-particle
    initialize, Extend updates and windowed MH) and the marked one: the
    same weights, choices and LML from one seed, and the state's
    [T*R, N] store contiguous."""
    y_obs, _ = tom.synthesize_data(G(42), 8, 4)
    before = BOUNDARY["calls"]
    pp = _om_filter(G(1), y_obs, 512, False, method)
    assert BOUNDARY["calls"] > before
    bb = _om_filter(G(1), y_obs, 512, True, method)
    np.testing.assert_allclose(pp.log_weights.numpy(),
                               bb.log_weights.numpy(), atol=1e-6)
    for k in ("moving", "y"):
        np.testing.assert_array_equal(tg.batched_choice(pp, k).numpy(),
                                      tg.batched_choice(bb, k).numpy())
    store = pp.traces.inner["store"]
    assert store.mat.is_contiguous() and tuple(store.mat.shape)[1] == 512


def test_state_built_by_one_path_updated_by_the_other():
    y_obs, _ = tom.synthesize_data(G(42), 6, 3)
    x0, obs = tom.init_state("cpu"), tom.obs_dense(y_obs)
    marked = tom.make_object_motion(6)
    unmarked = tg.Unfold(_unmarked(marked.step), 6)
    args = (2, x0), (tg.Extend(1), tg.NoChange())
    ref = tg.pf_update(G(2), tg.pf_initialize(G(1), marked, (1, x0), obs, 64),
                       *args, obs, check=False)
    m = (torch.arange(6) == 0) | (torch.arange(6) == 1)
    sel = (tg.Selection({("moving",): m, ("y",): m}),)
    ref_mh = tg.pf_rejuvenate(G(3), ref, tg.mh, sel, window=2)
    for first, second in ((marked, unmarked), (unmarked, marked)):
        st = tg.pf_initialize(G(1), first, (1, x0), obs, 64)
        st = tg.pf_update(G(2), _retyped(st, second), *args, obs,
                          check=False)
        np.testing.assert_allclose(st.log_weights.numpy(),
                                   ref.log_weights.numpy(), atol=1e-6)
        np.testing.assert_array_equal(tg.batched_choice(st, "y").numpy(),
                                      tg.batched_choice(ref, "y").numpy())
        # and the windowed MH of the one path on the other's state
        mh = tg.pf_rejuvenate(G(3), _retyped(st, second), tg.mh, sel,
                              window=2)
        np.testing.assert_array_equal(tg.batched_choice(mh, "y").numpy(),
                                      tg.batched_choice(ref_mh, "y").numpy())


def _both(fn, n=8):
    """``fn(gen)`` under a batched interpretation and per particle, from
    one seed."""
    with tg.batched_interpretation(n):
        b = fn(G(5))
    return b, vmap_gfi(lambda: fn(G(5)), n=n, device="cpu")


def _close(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            np.testing.assert_allclose(x.double().numpy(), torch.as_tensor(
                y).expand(x.shape).double().numpy(), atol=1e-5)


def test_unfold_verbs_per_particle_match_batched():
    """generate, the Extend update, the full re-scan update with an
    overwrite and a shrink, the windowed and full regenerates, ``_sel_logp``
    and ``assess`` on the line model, per particle and batched."""
    cm = line_choicemap(4, 1.0)
    sel = tg.Selection({("line", "outlier"): torch.arange(10) >= 2})

    def verbs(gen):
        tr, w = line_model.generate(gen, (3,), cm)
        ext, we, _, _ = tg.update(gen, tr, (4,), (tg.Extend(1, at="line"),),
                                  cm)
        full, wf, _, disc = tg.update(gen, ext, (4,), (tg.UnknownChange(),),
                                      tg.choicemap((("line", 0, "y"), 3.0)))
        shrink, ws, _, _ = tg.update(gen, full, (2,), (tg.UnknownChange(),),
                                     tg.EMPTY)
        reg_w, wrw = line_model.regenerate(gen, ext, (4,), (tg.NoChange(),),
                                           sel, window=2)
        reg, wr = line_model.regenerate(gen, ext, (4,), (tg.NoChange(),), sel)
        _, so, sc = line_model._sel_logp(ext, (4,), sel)
        unfold = line_model.fn.__globals__["line_unfold"]
        _, sa = unfold.assess(ext.inner["subs"][("line",)].args,
                              ext.get_choices().scope("line"))
        return (w, we, wf, ws, wrw, wr, so, sc, sa, ext.score, full.score,
                shrink.score, reg_w.score, reg.score,
                disc.entries[("line", "y")].value)
    b, p = _both(verbs)
    # discards are time-leading batched, particle-leading out of a map
    _close(b[:-1], p[:-1])
    _close(b[-1].T, p[-1])


@pytest.mark.parametrize("method,form", [("move", f) for f in list(FORMS)[:3]]
                         + [("reweight", f) for f in FORMS])
def test_every_kernel_form_per_particle_matches_batched(form, method):
    """mh and move_reweight in every form, two sweeps: an unmarked model
    runs them per particle (one map over the sweeps) with the batched
    weights, accepts and choices."""
    args, kw, _ = FORMS[form]
    kern = tg.mh if method == "move" else tg.move_reweight
    st = _state(6)
    outs = []
    for model in (TMODEL, _unmarked(TMODEL)):
        outs.append(tg.pf_rejuvenate(G(7), _retyped(st, model), kern,
                                     args, 2, method=method,
                                     return_stats=True, **kw))
    (b, bs), (p, ps) = outs
    np.testing.assert_allclose(p.log_weights.numpy(), b.log_weights.numpy(),
                               atol=1e-5)
    for k in ("b", "x"):
        np.testing.assert_array_equal(tg.batched_choice(p, k).numpy(),
                                      tg.batched_choice(b, k).numpy())
    for k in bs:
        np.testing.assert_allclose(ps[k].numpy(), bs[k].numpy(), atol=1e-5)


@pytest.mark.parametrize("n_iters", [1, 3])
def test_windowed_move_reweight_per_particle(n_iters):
    """move_reweight through the Unfold's window on the object-motion
    model, per particle and batched."""
    y_obs, _ = tom.synthesize_data(G(42), 6, 3)
    x0, obs = tom.init_state("cpu"), tom.obs_dense(y_obs)
    marked = tom.make_object_motion(6)
    st = tg.pf_initialize(G(1), marked, (4, x0), obs, 64)
    m = torch.arange(6) >= 2
    sel = tg.Selection({("moving",): m, ("y",): m})
    outs = [tg.pf_rejuvenate(G(3), _retyped(st, gf), tg.move_reweight,
                             (sel,), n_iters, method="reweight", window=2)
            for gf in (marked, tg.Unfold(_unmarked(marked.step), 6))]
    np.testing.assert_allclose(outs[1].log_weights.numpy(),
                               outs[0].log_weights.numpy(), atol=1e-5)


def _proposal(marked):
    @tg.gen
    def q():
        tg.trace(("line", 0, "outlier"), tg.bernoulli(0.5))
    q.batch_safe = marked
    return q


@pytest.mark.parametrize("strata", [False, True])
@pytest.mark.parametrize("with_proposal", [False, True])
def test_initialize_forms_per_particle(strata, with_proposal):
    """Plain, proposal and strata initialize per particle: the batched
    weights from one seed."""
    kw = {}
    if strata:
        kw = dict(strata=[slope_choicemap(s) for s in range(-2, 3)],
                  layout="interleaved")
    outs = []
    for marked in (True, False):
        model = line_model if marked else UNMARKED_LINE
        if with_proposal:
            kw.update(proposal=_proposal(marked), proposal_args=())
        outs.append(tg.pf_initialize(G(8), model, (1,), line_choicemap(1),
                                     40, **kw))
    np.testing.assert_allclose(outs[1].log_weights.numpy(),
                               outs[0].log_weights.numpy(), atol=1e-6)
    np.testing.assert_array_equal(tg.batched_choice(outs[1], "slope"),
                                  tg.batched_choice(outs[0], "slope"))


@pytest.mark.parametrize("form", ["default", "proposal", "translator"])
def test_stratified_update_forms_per_particle(form):
    """Stratified pf_update per particle (default proposal, an extending
    proposal, and the strata meeting a translator, which always runs per
    particle) against the batched default-proposal weights."""
    strata = [tg.choicemap((("line", 1, "outlier"), v)) for v in (False,
                                                                   True)]
    base = tg.pf_initialize(G(0), line_model, (1,), line_choicemap(1), 40)
    cm = tg.choicemap((("line", 1, "y"), 2.0))
    ref = tg.pf_update(G(1), base, (2,), (tg.UnknownChange(),), cm,
                       strata=strata)
    st = _retyped(base, UNMARKED_LINE)
    if form == "default":
        out = tg.pf_update(G(1), st, (2,), (tg.UnknownChange(),), cm,
                           strata=strata)
    else:
        tr = tg.ExtendingTraceTranslator(
            p_new_args=(2,), p_argdiffs=(tg.UnknownChange(),),
            new_observations=cm)
        out = tg.pf_update(G(1), base if form == "translator" else st,
                           translator=tr, strata=strata)
    np.testing.assert_allclose(out.log_weights.numpy(),
                               ref.log_weights.numpy(), atol=1e-5)
    np.testing.assert_array_equal(
        tg.batched_choice(out, ("line", 1, "outlier")).numpy(),
        np.arange(40) % 2 == 1)


def test_introduce_per_particle():
    st = tg.pf_initialize(G(0), UNMARKED_LINE, (2,), line_choicemap(2), 24)
    ref = tg.pf_initialize(G(0), line_model, (2,), line_choicemap(2), 24)
    out = tg.pf_introduce(G(1), st, line_choicemap(2), 8)
    refo = tg.pf_introduce(G(1), ref, line_choicemap(2), 8)
    assert out.n_particles == 32
    np.testing.assert_allclose(out.log_weights.numpy(),
                               refo.log_weights.numpy(), atol=1e-6)
    assert _shapes(out.traces)[0] == _shapes(st.traces)[0]


def test_checks_wait_until_the_map_returns():
    """A discard, a modified observation and a failed assess coverage raise
    after a per-particle map, as they do batched."""
    st = tg.pf_initialize(G(0), UNMARKED_LINE, (2,), line_choicemap(2), 16)
    with pytest.raises(ValueError, match="updated or deleted"):
        tg.pf_update(G(1), st, (2,), (tg.UnknownChange(),),
                     tg.choicemap((("line", 0, "y"), 5.0)))
    tg.pf_update(G(1), st, (2,), (tg.UnknownChange(),),
                 tg.choicemap((("line", 0, "y"), 5.0)), check=False)

    @tg.gen
    def clobber(tr):
        tg.trace("y", tg.normal(100.0, 0.01))
    obs = tg.choicemap(("y", 0.7))
    with pytest.raises(ValueError, match="was modified"):
        tg.pf_rejuvenate(G(2), _retyped(_state(3), _unmarked(TMODEL)),
                         tg.move_reweight, (clobber, ()), method="reweight",
                         check=True, observations=obs)
    unfold = line_model.fn.__globals__["line_unfold"]
    sparse = tg.ChoiceMap({("y",): tg.Entry(torch.zeros(10), torch.arange(
        10) != 1), ("outlier",): tg.Entry(torch.zeros(10, dtype=torch.bool))})
    with pytest.raises(ValueError, match="missing at some active"):
        vmap_gfi(lambda: unfold.assess((3, torch.zeros(()), torch.ones(())),
                                       sparse), n=4, device="cpu")


def test_batched_choice_entry():
    st = tg.pf_initialize(G(0), line_model, (3,), line_choicemap(3), 12)
    ch = st.traces.get_choices()
    axes = st.traces.gen_fn.trace_choice_axes(st.traces, 0)
    v, m = tg.batched_choice_entry(ch, ("line", 1, "outlier"), axes, 12)
    assert tuple(v.shape) == (12,) and tuple(m.shape) == (12,)
    np.testing.assert_array_equal(
        v.numpy(), tg.batched_choice(st, ("line", 1, "outlier")).numpy())
    with tg.batched_interpretation(None):
        tr = UNMARKED_LINE.simulate(G(1), (3,))
    v1, _ = tg.batched_choice_entry(tr.get_choices(), ("line", 2, "y"))
    assert v1.shape == () and float(v1) == float(
        tr.get_choices()[("line", "y")][2])
    with pytest.raises(KeyError):
        tg.batched_choice_entry(ch, "nope")


# ---------------------------------------------------------------------------
# Ground truths
# ---------------------------------------------------------------------------

def _slope_posterior(ys):
    Z = {}
    for s in range(-2, 3):
        tot = 0.0
        for outl in itertools.product([False, True], repeat=len(ys)):
            lp = math.log(1 / 5)
            for t, y in enumerate(ys):
                lp += math.log(0.1 if outl[t] else 0.9)
                lp += lp_normal(y, (t + 1) * s, 10.0 if outl[t] else 1.0)
            tot += math.exp(lp)
        Z[s] = tot
    total = sum(Z.values())
    return {s: z / total for s, z in Z.items()}


def test_slope_posterior_per_particle_vs_enumeration():
    st = tg.pf_initialize(G(3), UNMARKED_LINE, (4,), line_choicemap(4, 1.0),
                          4096)
    w = tg.get_norm_weights(st).double().numpy()
    slopes = tg.batched_choice(st, "slope").numpy()
    exact = _slope_posterior([(t + 1) * 1.0 for t in range(4)])
    for s in range(-2, 3):
        assert abs(w[slopes == s].sum() - exact[s]) < 0.05


def test_mh_stationarity_per_particle():
    st = tg.pf_initialize(G(5), UNMARKED_LINE, (4,), line_choicemap(4, 1.0),
                          4096)
    st2 = tg.pf_rejuvenate(G(6), st, tg.mh, (tg.select("slope"),), 3)
    w = tg.get_norm_weights(st).double().numpy()
    s1 = tg.batched_choice(st, "slope").numpy()
    s2 = tg.batched_choice(st2, "slope").numpy()
    for s in range(-2, 3):
        assert abs(w[s1 == s].sum() - w[s2 == s].sum()) < 0.06
    assert torch.equal(st.log_weights, st2.log_weights)


def test_lml_unbiased_per_particle_vs_kalman():
    from genparticlefilters_tpu_torch.models.linear_gaussian import (
        LGParams, make_lgssm, lg_obs_dense, kalman_filter,
        synthesize_lg_data)
    from genparticlefilters_tpu_torch.smc.algorithms import (
        run_particle_filter)
    p = LGParams(a=0.6, q=0.7, r=0.6)
    T = 4
    y = synthesize_lg_data(G(1), T, p)
    _, _, lml_exact = kalman_filter(y.numpy(), p)
    model = make_lgssm(T, p)
    model.step.batch_safe = False
    x0, obs = torch.zeros(()), lg_obs_dense(y)
    z = []
    for s in range(24):
        st = run_particle_filter(G(200 + s), model, T, 256,
                                 step_args_fn=lambda t: (t + 1, x0),
                                 obs_fn=lambda t: obs)
        z.append(math.exp(float(tg.log_ml_estimate(st)) - lml_exact))
    z = np.asarray(z)
    assert abs(z.mean() - 1.0) < 4 * z.std() / math.sqrt(len(z)) + 0.05


XS = torch.linspace(-1.0, 1.0, 8)
YS = torch.tensor([0.5, 0.2, -0.1, 0.3, 0.8, 1.0, 1.6, 2.1])


@tg.gen
def quadratic(xs):
    """mu ~ N(0, I_3); y_i ~ N(mu[0] + mu[1] x_i + mu[2] x_i², 1): the
    positional reads mu[k] of an event vector need the per-particle
    interpretation."""
    mu = tg.trace("mu", tg.mvnormal_diag(torch.zeros(3), torch.ones(3)))
    for i in range(8):
        tg.trace(("y", i), tg.normal(mu[0] + mu[1] * xs[i]
                                     + mu[2] * xs[i] ** 2, 1.0))
    return mu


def quadratic_exact():
    """(log Z, posterior mean of mu) in float64: y ~ N(0, I + Φ Φᵀ)."""
    phi = torch.stack([torch.ones(8), XS, XS ** 2], 1).double()
    cov = torch.eye(8, dtype=torch.float64) + phi @ phi.T
    y = YS.double()
    log_z = float(-0.5 * y @ torch.linalg.solve(cov, y)
                  - 0.5 * torch.logdet(2 * math.pi * cov))
    post = torch.linalg.solve(torch.eye(3, dtype=torch.float64)
                              + phi.T @ phi, phi.T @ y)
    return log_z, post.numpy()


def test_positional_model_conjugate_posterior():
    obs = tg.choicemap(*[(("y", i), float(YS[i])) for i in range(8)])
    log_z, post = quadratic_exact()
    lmls, means = [], []
    for s in range(4):
        st = tg.pf_initialize(G(20 + s), quadratic, (XS,), obs, 4096)
        st = tg.pf_rejuvenate(G(30 + s), st, tg.mh, (tg.select("mu"),), 2)
        lmls.append(float(tg.log_ml_estimate(st)))
        means.append((tg.get_norm_weights(st)[:, None].double()
                      * tg.batched_choice(st, "mu").double()).sum(0).numpy())
    assert abs(np.mean(lmls) - log_z) < 6 * np.std(lmls) / 2 + 0.05
    means = np.array(means)
    assert np.all(np.abs(means.mean(0) - post)
                  < 6 * means.std(0) / 2 + 0.05)


# ---------------------------------------------------------------------------
# The batched-layout guard
# ---------------------------------------------------------------------------

def _collide(k):
    @tg.gen
    def collide_model(_):
        base = torch.arange(k, dtype=torch.float32)   # an event vector
        return tg.trace("x", tg.normal(base, 1.0))
    collide_model.batch_safe = True
    return collide_model


def test_batched_shape_collision_raises():
    st = tg.pf_initialize(G(0), _collide(64), (0,), tg.EMPTY, 32)
    assert tuple(tg.batched_choice(st, "x").shape) == (32, 64)
    with pytest.raises(ValueError, match="misread as per-particle"):
        tg.pf_initialize(G(0), _collide(64), (0,), tg.EMPTY, 64)
    # the same model per particle reads the event vector right
    pp = tg.pf_initialize(G(0), _unmarked(_collide(64)), (0,), tg.EMPTY, 64)
    assert tuple(tg.batched_choice(pp, "x").shape) == (64, 64)


def test_batched_guard_can_be_disabled():
    with tconfig.use_check_batched_layout(False):
        st = tg.pf_initialize(G(0), _collide(16), (0,), tg.EMPTY, 16)
    assert tuple(tg.batched_choice(st, "x").shape) == (16,)
    assert tconfig.check_batched_layout


def test_guard_draws_nothing_and_caches():
    """A guarded run draws and returns exactly what an unguarded one does
    (the guard runs on fake tensors), and a second call with the same
    shapes is a cache hit."""
    y_obs, _ = tom.synthesize_data(G(42), 6, 3)
    runs = []
    for guard in (True, False, True):
        with tconfig.use_check_batched_layout(guard):
            runs.append(_om_filter(G(1), y_obs, 128, True, t_max=6))
    for st in runs[1:]:
        assert torch.equal(st.log_weights, runs[0].log_weights)
    traces = tg.pf_initialize(G(0), line_model, (1,), tg.EMPTY, 4).traces
    gen = G(9)
    state = gen.get_state()
    evaluated = []

    def per_particle():
        evaluated.append(1)
        return line_model.generate(gen, (1,), tg.EMPTY)[0]
    for _ in range(2):
        check_batched_layout(traces, per_particle, 4, key=("probe", 4))
    assert len(evaluated) == 1
    assert torch.equal(gen.get_state(), state)


def test_vmap_gfi_runs_on_the_card_unless_asked():
    """With no mapped argument the map is placed on ``device``: the card
    by default, which raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places the map on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vmap_gfi(lambda: torch.zeros(()), n=4)
    out = vmap_gfi(lambda: (torch.zeros(()), 3, 2.5), n=4, device="cpu")
    assert tuple(out[0].shape) == (4,) and out[0].device.type == "cpu"
    # a Python number returned per particle gets the particle axis, as a
    # JAX map returns it
    assert out[1].dtype == torch.int32 and out[2].dtype == torch.float32
    assert tuple(out[1].shape) == (4,) and float(out[2][3]) == 2.5
