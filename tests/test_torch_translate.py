"""Trace translators of the port (genparticlefilters_tpu_torch/smc/
translate.py) and pf_update's translator dispatch.

- ``TraceTransform`` log|det J| against JAX's on the same numpy inputs
  (atol 1e-5): a shift, the scaling x·e^eps and a coupled non-diagonal
  2-D map, per particle and under a batched interpretation (a vmapped
  ``jacfwd``).
- Extending, Updating (Del Moral and SMCP³) and General translator
  weights against their exact float64 value recomputed from the traces
  the port produced (atol 1e-4, float32 densities), per particle and
  batched through ``pf_update``.
- The round-trip check passes a true inverse and raises on a broken one;
  the discard check raises.
- The batched translator's state has the leaf shapes and dtypes of a
  state made by ``pf_initialize``; strata with a general translator and a
  translator on a model that is not batch-safe raise.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.core.gfi import (  # noqa: E402
    batched_interpretation as jbatched)
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.models.tempered import (  # noqa: E402
    make_tempered_model, tempered_loglik, PRIOR_LOC, PRIOR_SCALE)

N = 64


def lp_normal(x, mu, s):
    return -0.5 * ((x - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(
        2 * math.pi)


def lp_bern(v, p):
    return math.log(p if v else 1.0 - p)


# -- the transforms, written once per framework ----------------------------

def _shift(lib, ex):
    def fn(prev, fwd):
        eps, x = fwd[("eps",)], prev[("x",)]
        return (lib.ChoiceMap({("x",): lib.Entry(x + eps, True)}),
                lib.ChoiceMap({("eps",): lib.Entry(-eps, True)}))
    return fn


def _scale(lib, ex):
    def fn(prev, fwd):
        eps, x = fwd[("eps",)], prev[("x",)]
        return (lib.ChoiceMap({("x",): lib.Entry(x * ex.exp(eps), True)}),
                lib.ChoiceMap({("eps",): lib.Entry(-eps, True)}))
    return fn


def _coupled(lib, ex):
    def fn(prev, fwd):
        eps, x = fwd[("eps",)], prev[("x",)]
        return (lib.ChoiceMap({("x",): lib.Entry(
                    x * ex.cosh(eps) + 0.3 * ex.sin(eps), True)}),
                lib.ChoiceMap({("eps",): lib.Entry(
                    ex.tanh(x) + 2.0 * eps - 0.1 * x * eps, True)}))
    return fn


IO = dict(continuous_in=(("prev", "x"), ("fwd", "eps")),
          continuous_out=(("model", "x"), ("bwd", "eps")))


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("make", [_shift, _scale, _coupled])
def test_transform_logdet_matches_jax(make, batched):
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 2, N).astype(np.float32)
    es = rng.normal(0, 0.5, N).astype(np.float32)
    jt = jg.TraceTransform(make(jg, jnp), **IO)
    tt = tg.TraceTransform(make(tg, torch), **IO)
    if batched:
        with jbatched(N):
            jm, jb, jld = jt.apply_updating(
                jg.choicemap(("x", jnp.asarray(xs))),
                jg.choicemap(("eps", jnp.asarray(es))))
        with tg.batched_interpretation(N):
            tm, tb, tld = tt.apply_updating(
                tg.choicemap(("x", torch.from_numpy(xs))),
                tg.choicemap(("eps", torch.from_numpy(es))))
        assert tuple(tld.shape) == (N,)
        np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-5)
        np.testing.assert_allclose(tm[("x",)].numpy(), np.asarray(jm[("x",)]),
                                   atol=1e-5)
        np.testing.assert_allclose(tb[("eps",)].numpy(),
                                   np.asarray(jb[("eps",)]), atol=1e-5)
        return
    for i in range(4):
        _, _, jld = jt.apply_updating(jg.choicemap(("x", xs[i])),
                                      jg.choicemap(("eps", es[i])))
        _, _, tld = tt.apply_updating(tg.choicemap(("x", xs[i])),
                                      tg.choicemap(("eps", es[i])))
        np.testing.assert_allclose(float(tld), float(jld), atol=1e-5)


def test_transform_not_square_raises():
    def fn(prev, fwd):
        return (tg.choicemap(("x", prev["x"] + fwd["eps"])), tg.EMPTY)
    bad = tg.TraceTransform(fn, continuous_in=(("prev", "x"), ("fwd", "eps")),
                            continuous_out=(("model", "x"),))
    with pytest.raises(ValueError, match="not square"):
        bad.apply_updating(tg.choicemap(("x", 1.0)),
                           tg.choicemap(("eps", 0.5)))


# -- exact translator weights ---------------------------------------------

@tg.gen
def xy_model(T):
    for t in range(1, T + 1):
        x = tg.trace(("x", t), tg.normal(0.0, 1.0))
        tg.trace(("y", t), tg.normal(x, 1.0))


xy_model.batch_safe = True
OBS = tg.choicemap((("y", 1), 0.0))


def _xy_pairs(tr):
    x = np.atleast_1d(tr[("x", 1)].numpy()).astype(np.float64)
    y = np.atleast_1d(tr[("y", 1)].numpy()).astype(np.float64)
    return x, y


def _run_translator(translator, batched, **kw):
    """(new trace, weight) per particle, or batched through pf_update."""
    gen = torch.Generator().manual_seed(7)
    if not batched:
        tr, _ = xy_model.generate(gen, (0,))
        return translator(gen, tr, **kw)
    st = tg.pf_initialize(gen, xy_model, (0,), tg.EMPTY, N)
    st2 = tg.pf_update(gen, st, translator=translator, **kw)
    return st2.traces, st2.log_weights - st.log_weights


@pytest.mark.parametrize("batched", [False, True])
def test_extending_translator_exact(batched):
    @tg.gen
    def proposal(tr, t):
        tg.trace("x", tg.normal(0.0, 1.0))

    proposal.batch_safe = True
    transform = tg.TraceTransform(
        lambda fwd: tg.ChoiceMap({("x", 1): tg.Entry(2.0 * fwd[("x",)],
                                                     True)}),
        continuous_in=[("fwd", "x")], continuous_out=[("model", ("x", 1))])
    for prop, tf in ((None, None), (proposal, transform)):
        translator = tg.ExtendingTraceTranslator(
            p_new_args=(1,), new_observations=OBS, q_forward=prop,
            q_forward_args=(1,), transform=tf)
        tr, w = _run_translator(translator, batched, check=True)
        x, y = _xy_pairs(tr)
        assert np.all(y == 0.0)
        want = lp_normal(y, x, 1.0)
        if prop is not None:   # N(0,2) pushforward of the proposal
            want = want + lp_normal(x, 0, 1.0) - lp_normal(x, 0, 2.0)
        np.testing.assert_allclose(np.atleast_1d(w.numpy()), want,
                                   atol=1e-4)


def _smcp3(break_inverse=False):
    @tg.gen
    def fwd_kernel(tr):
        tg.trace("u", tg.bernoulli(0.25))
        tg.trace("x", tg.normal(0.0, 1.0))

    @tg.gen
    def bwd_kernel(tr):
        tg.trace("u", tg.bernoulli(0.75))

    fwd_kernel.batch_safe = bwd_kernel.batch_safe = True

    def fwd_fn(prev, fwd):
        return (tg.ChoiceMap({("x", 1): tg.Entry(2.0 * fwd[("x",)], True)}),
                tg.ChoiceMap({("u",): tg.Entry(fwd[("u",)], True)}))

    scale = 0.25 if break_inverse else 0.5

    def bwd_fn(prev, fwd):
        return (tg.EMPTY, tg.ChoiceMap({
            ("u",): tg.Entry(fwd[("u",)], True),
            ("x",): tg.Entry(prev[("x", 1)] * scale, True)}))

    transform = tg.TraceTransform(
        fwd_fn, continuous_in=[("fwd", "x")],
        continuous_out=[("model", ("x", 1))], inverse_fn=bwd_fn,
        inverse_continuous_in=[("prev", ("x", 1))],
        inverse_continuous_out=[("bwd", "x")])
    return tg.UpdatingTraceTranslator(
        p_new_args=(1,), p_prev_args=(0,), new_observations=OBS,
        q_forward=fwd_kernel, q_backward=bwd_kernel, transform=transform)


@pytest.mark.parametrize("batched", [False, True])
def test_updating_translator_smcp3_exact(batched):
    tr, w = _run_translator(_smcp3(), batched, check=True)
    x, y = _xy_pairs(tr)
    base = lp_normal(y, x, 1.0) + lp_normal(x, 0, 1.0) - lp_normal(x, 0, 2.0)
    w = np.atleast_1d(w.numpy()).astype(np.float64)
    aux = math.log(0.25) - math.log(0.75)
    ok = np.minimum(np.abs(w - (base + aux)), np.abs(w - (base - aux)))
    assert np.all(ok < 1e-4), ok


@pytest.mark.parametrize("batched", [False, True])
def test_round_trip_check_raises_on_a_broken_inverse(batched):
    with pytest.raises(ValueError, match="round-trip check failed"):
        _run_translator(_smcp3(break_inverse=True), batched, check=True)


def test_del_moral_translator_exact_and_discard_check():
    """No transform: the forward proposal's choices replace the model's,
    the discarded ones are assessed under the backward proposal."""
    @tg.gen
    def model(mu):
        b = tg.trace("b", tg.bernoulli(0.3))
        tg.trace("y", tg.normal(mu + torch.where(b, 2.0, 0.0), 1.0))

    @tg.gen
    def q_fwd(tr):
        tg.trace("b", tg.bernoulli(0.0))

    @tg.gen
    def q_bwd(tr):
        tg.trace("b", tg.bernoulli(0.1))

    model.batch_safe = q_fwd.batch_safe = q_bwd.batch_safe = True
    obs = tg.choicemap(("y", 0.5))
    st = tg.pf_initialize(torch.Generator().manual_seed(3), model,
                          (torch.tensor(0.0),), obs, N)
    b_old = tg.batched_choice(st, "b").numpy()
    st2 = tg.pf_update(torch.Generator(), st, (torch.tensor(0.0),),
                       (tg.UnknownChange(),), tg.EMPTY, proposal=q_fwd,
                       proposal_args=(), bwd_proposal=q_bwd, bwd_args=())
    assert not tg.batched_choice(st2, "b").any()
    got = (st2.log_weights - st.log_weights).numpy()
    for i in range(N):
        o = bool(b_old[i])
        want = (lp_bern(False, 0.3) + lp_normal(0.5, 0.0, 1.0)
                - lp_bern(o, 0.3) - lp_normal(0.5, 2.0 if o else 0.0, 1.0)
                + lp_bern(o, 0.1))
        np.testing.assert_allclose(got[i], want, atol=1e-4)
    # an extending translator that overwrites an observation is refused
    with pytest.raises(ValueError, match="updated or deleted"):
        tg.pf_update(torch.Generator(), st, (torch.tensor(0.0),),
                     (tg.UnknownChange(),), tg.choicemap(("y", 1.0)),
                     proposal=q_fwd, proposal_args=())


@pytest.mark.parametrize("batched", [False, True])
def test_general_translator_across_models(batched):
    """x ~ N(0, 2) reparameterized as z ~ N(0, 1), x = 2z: the pushforward
    is exact, so every weight is 0."""
    @tg.gen
    def model_a():
        tg.trace("x", tg.normal(0.0, 2.0))

    @tg.gen
    def model_b():
        tg.trace("z", tg.normal(0.0, 1.0))

    model_a.batch_safe = model_b.batch_safe = True
    translator = tg.GeneralTraceTranslator(
        new_model=model_b, transform=tg.TraceTransform(
            lambda prev, fwd: (tg.ChoiceMap({("z",): tg.Entry(
                prev[("x",)] / 2.0, True)}), tg.EMPTY),
            continuous_in=[("prev", "x")], continuous_out=[("model", "z")]))
    gen = torch.Generator().manual_seed(1)
    if batched:
        st = tg.pf_initialize(gen, model_a, (), tg.EMPTY, N)
        st2 = tg.pf_update(gen, st, translator=translator, check=False)
        np.testing.assert_allclose(tg.batched_choice(st2, "z").numpy(),
                                   tg.batched_choice(st, "x").numpy() / 2,
                                   atol=1e-6)
        np.testing.assert_allclose(st2.log_weights.numpy(),
                                   st.log_weights.numpy(), atol=1e-5)
        return
    for _ in range(5):
        tr = model_a.simulate(gen, ())
        new_tr, w = translator(gen, tr)
        assert abs(float(new_tr["z"]) - float(tr["x"]) / 2) < 1e-6
        assert abs(float(w)) < 1e-5


# -- the batched SMCP³ step on the tempered model --------------------------

def _tempered_kernels():
    @tg.gen
    def fwd(tr):
        tg.trace("eps", tg.normal(0.0, 0.25))

    @tg.gen
    def bwd(tr):
        tg.trace("eps", tg.normal(0.0, 0.25))

    fwd.batch_safe = bwd.batch_safe = True
    return make_tempered_model(), fwd, bwd


def _score(x, beta):
    return lp_normal(x, PRIOR_LOC, PRIOR_SCALE) + beta * tempered_loglik(
        torch.from_numpy(x).to(torch.float32)).double().numpy()


@pytest.mark.parametrize("make,jac", [(_shift, False), (_scale, True)])
def test_batched_smcp3_step_exact_and_leaf_shapes(make, jac):
    """w = Δscore + log|det J| − fwd + bwd, recomputed in float64 from the
    produced traces (the check of tests/test_translate.py), and the new
    state's leaves are shaped like an initialized state's."""
    model, fwd, bwd = _tempered_kernels()
    b0, b1 = torch.tensor(0.2), torch.tensor(0.9)
    st = tg.pf_initialize(torch.Generator().manual_seed(2), model, (b0,),
                          tg.EMPTY, N)
    tf = tg.TraceTransform(make(tg, torch), **(IO if jac else {}))
    tr = tg.UpdatingTraceTranslator(p_new_args=(b1,),
                                    p_argdiffs=(tg.UnknownChange(),),
                                    q_forward=fwd, q_backward=bwd,
                                    transform=tf)
    st2 = tg.pf_update(torch.Generator().manual_seed(3), st, translator=tr,
                       check=False)
    x_old = tg.batched_choice(st, "x").double().numpy()
    x_new = tg.batched_choice(st2, "x").double().numpy()
    eps = np.log(x_new / x_old) if jac else x_new - x_old
    want = (_score(x_new, 0.9) - _score(x_old, 0.2) + (eps if jac else 0.0)
            - lp_normal(eps, 0.0, 0.25) + lp_normal(-eps, 0.0, 0.25))
    got = (st2.log_weights - st.log_weights).double().numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)
    ref = tg.pf_initialize(torch.Generator(), model, (b1,), tg.EMPTY, N)
    for a, b in zip(tree_leaves(st2), tree_leaves(ref)):
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)
    assert tuple(st2.traces.inner["sites"][("x",)].value.shape) == (N,)


def test_translator_paths_that_wait_raise():
    model, fwd, bwd = _tempered_kernels()
    st = tg.pf_initialize(torch.Generator(), model, (torch.tensor(0.2),),
                          tg.EMPTY, N)
    tr = tg.UpdatingTraceTranslator(p_new_args=(torch.tensor(0.5),),
                                    q_forward=fwd, q_backward=bwd,
                                    transform=tg.TraceTransform(
                                        _shift(tg, torch)))
    strata = tg.choiceproduct(("eps", [0.1, -0.1]))
    # strata reach a translator through its new observations, which a
    # general translator does not have
    gtr = tg.GeneralTraceTranslator(model, (torch.tensor(0.5),))
    with pytest.raises(NotImplementedError, match="extending and updating"):
        tg.pf_update(torch.Generator(), st, translator=gtr, strata=strata)
    unsafe = tg.gen(fwd.fn)
    tr2 = tg.UpdatingTraceTranslator(p_new_args=(torch.tensor(0.5),),
                                     q_forward=unsafe, q_backward=bwd)
    with pytest.raises(NotImplementedError, match="slice 9"):
        tg.pf_update(torch.Generator(), st, translator=tr2)
