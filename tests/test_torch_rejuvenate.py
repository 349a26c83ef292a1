"""Rejuvenation of the port (genparticlefilters_tpu_torch/smc/
rejuvenate.py): ``mh`` and ``move_reweight`` in every form, the sweeps'
stats, and update / rejuvenate on sub-state views.

- Exact weights (atol 1e-4, float32 densities): each kernel's weight is
  recomputed in float64 from the traces it produced. The MH accept
  decision is replayed from a copy of the generator: the kernel draws its
  proposal, then one uniform per particle.
- A deterministic move (a proposal that always draws False) on a state
  carried over from the JAX package gives JAX's relative weights (atol
  1e-5).
- On a view, particles outside it come back bit-equal, and the view's
  particles as the verb run on the taken block (same generator seed)
  returns them.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import tree_take  # noqa
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.interop import state_from_numpy  # noqa
from genparticlefilters_tpu_torch.models import object_motion as tom  # noqa

N = 48
Y = 0.7


def lp_normal(x, mu, s):
    return -0.5 * ((x - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(
        2 * math.pi)


def lp_bern(v, p):
    return math.log(p if v else 1.0 - p)


def _model(lib, ex):
    @lib.gen
    def model(mu):
        b = lib.trace("b", lib.bernoulli(0.3))
        x = lib.trace("x", lib.normal(mu, ex.where(b, 2.0, 1.0)))
        lib.trace("y", lib.normal(x, 1.0))
        return x

    @lib.gen
    def flip_to_false(tr):
        lib.trace("b", lib.bernoulli(0.0))

    model.batch_safe = flip_to_false.batch_safe = True
    return model, flip_to_false


TMODEL, TFALSE = _model(tg, torch)


@tg.gen
def b_proposal(tr):
    tg.trace("b", tg.bernoulli(0.9))


@tg.gen
def coin(tr):
    tg.trace("u", tg.bernoulli(0.5))


b_proposal.batch_safe = coin.batch_safe = True


def _log_joint(b, x, mu=0.2):
    return (lp_bern(b, 0.3) + lp_normal(x, mu, 2.0 if b else 1.0)
            + lp_normal(Y, x, 1.0))


def _state(seed=0):
    return tg.pf_initialize(torch.Generator().manual_seed(seed), TMODEL,
                            (torch.tensor(0.2),), tg.choicemap(("y", Y)), N)


def _bx(traces):
    return (traces["b"].numpy(), traces["x"].numpy().astype(np.float64))


def _reflect(trace, fwd_choices, fwd_ret, p_args):
    """x -> −x: an involution; the weight is the model's score ratio."""
    new_tr, w, _, _ = TMODEL.update(None, trace, trace.get_args(), None,
                                    tg.choicemap(("x", -trace["x"])))
    return new_tr, tg.ChoiceMap({("u",): tg.Entry(fwd_choices[("u",)],
                                                  True)}), w


def _reflect_b(trace, fwd_choices, fwd_ret, p_args):
    """The reflection, its backward choice the flag b (for a distinct
    backward proposal that scores b)."""
    new_tr, _, w = _reflect(trace, fwd_choices, fwd_ret, p_args)
    return new_tr, tg.choicemap(("b", new_tr["b"])), w


FORMS = {   # name -> (kernel args, kwargs, exact weight(old, new))
    "selection": ((tg.select("x"),), {},
                  lambda o, n: lp_normal(Y, n[1], 1.0)
                  - lp_normal(Y, o[1], 1.0)),
    "proposal": ((b_proposal, ()), {},
                 lambda o, n: _log_joint(n[0], n[1]) - _log_joint(o[0], o[1])
                 - lp_bern(n[0], 0.9) + lp_bern(o[0], 0.9)),
    "involution": ((coin, ()), {"involution": _reflect},
                   lambda o, n: _log_joint(n[0], n[1])
                   - _log_joint(o[0], o[1])),
    "involution, bwd proposal": (
        (coin, ()), {"involution": _reflect_b, "bwd_proposal": b_proposal,
                     "bwd_args": ()},
        lambda o, n: _log_joint(n[0], n[1]) - _log_joint(o[0], o[1])
        - math.log(0.5) + lp_bern(n[0], 0.9)),
}


def _fresh_copy(gen):
    g2 = torch.Generator()
    g2.set_state(gen.get_state())
    return g2


@pytest.mark.parametrize("form", list(FORMS))
def test_move_reweight_exact_weights(form):
    args, kw, weight = FORMS[form]
    st = _state()
    gen = torch.Generator().manual_seed(11)
    with tg.batched_interpretation(N):
        new_tr, w = tg.move_reweight(gen, st.traces, *args, **kw)
    old, new = _bx(st.traces), _bx(new_tr)
    for i in range(N):
        o, n = (old[0][i], old[1][i]), (new[0][i], new[1][i])
        np.testing.assert_allclose(float(w[i]), weight(o, n), atol=1e-4)


@pytest.mark.parametrize("form", ["selection", "proposal", "involution"])
def test_mh_accepts_by_the_exact_weight(form):
    args, kw, weight = FORMS[form]
    st = _state(1)
    gen = torch.Generator().manual_seed(12)
    replay = _fresh_copy(gen)
    with tg.batched_interpretation(N):
        out, accept = tg.mh(gen, st.traces, *args, **kw)
        prop, _ = tg.move_reweight(replay, st.traces, *args, **kw)
    u = torch.rand((N,), generator=replay).numpy().astype(np.float64)
    old, new, got = _bx(st.traces), _bx(prop), _bx(out)
    for i in range(N):
        w = weight((old[0][i], old[1][i]), (new[0][i], new[1][i]))
        assert bool(accept[i]) == (math.log(u[i]) < w), (i, w, u[i])
        src = new if accept[i] else old
        assert got[0][i] == src[0][i] and got[1][i] == src[1][i]
    assert accept.dtype == torch.bool


def test_mh_involution_on_a_symmetric_target_always_accepts():
    @tg.gen
    def sym():
        tg.trace("x", tg.normal(0.0, 1.0))

    def reflect(trace, fwd_choices, fwd_ret, p_args):
        new_tr, w, _, _ = sym.update(None, trace, (), None,
                                     tg.choicemap(("x", -trace["x"])))
        return new_tr, tg.ChoiceMap({("u",): tg.Entry(fwd_choices[("u",)],
                                                      True)}), w

    gen = torch.Generator().manual_seed(2)
    tr = sym.simulate(gen, ())
    new_tr, accept = tg.mh(gen, tr, coin, (), involution=reflect)
    assert bool(accept)
    assert float(new_tr["x"]) == -float(tr["x"])


def test_deterministic_move_matches_jax():
    jmodel, jfalse = _model(jg, jnp)
    jst = jg.pf_initialize(jr.key(0), jmodel, (jnp.float32(0.2),),
                           jg.choicemap(("y", Y)), N)
    leaves = [np.array(x) for x in jax.tree_util.tree_flatten(jst)[0]]
    tst = state_from_numpy(TMODEL, leaves, (torch.tensor(0.2),),
                           tg.choicemap(("y", Y)), device="cpu")
    jout, jstats = jg.pf_move_reweight(jr.key(1), jst, jg.move_reweight,
                                       (jfalse, ()), 2, return_stats=True)
    tout, tstats = tg.pf_move_reweight(torch.Generator(), tst,
                                       tg.move_reweight, (TFALSE, ()), 2,
                                       return_stats=True)
    np.testing.assert_allclose(tstats["rel_weights"].numpy(),
                               np.asarray(jstats["rel_weights"]), atol=1e-5)
    np.testing.assert_allclose(tout.log_weights.numpy(),
                               np.asarray(jout.log_weights), atol=1e-5)
    assert not tg.batched_choice(tout, "b").any()


@pytest.mark.parametrize("n_iters", [1, 3])
def test_sweep_stats(n_iters):
    st = _state(2)
    out, stats = tg.pf_move_reweight(torch.Generator().manual_seed(3), st,
                                     tg.move_reweight, (tg.select("x"),),
                                     n_iters, return_stats=True)
    rel = stats["rel_weights"]
    assert tuple(rel.shape) == (N, n_iters) and rel.dtype == torch.float32
    np.testing.assert_allclose(out.log_weights.numpy(),
                               (st.log_weights + rel.sum(1)).numpy(),
                               atol=1e-5)
    out2, stats2 = tg.pf_rejuvenate(torch.Generator().manual_seed(4), st,
                                    tg.mh, (tg.select("x"),), n_iters,
                                    return_stats=True)
    assert tuple(stats2["accepts"].shape) == (N, n_iters)
    assert 0.0 <= float(stats2["accept_rate"]) <= 1.0
    assert torch.equal(out2.log_weights, st.log_weights)


def test_check_observations():
    st = _state(3)

    @tg.gen
    def clobber(tr):
        tg.trace("y", tg.normal(100.0, 0.01))

    clobber.batch_safe = True
    obs = tg.choicemap(("y", Y))
    tg.pf_rejuvenate(torch.Generator(), st, tg.move_reweight,
                     (b_proposal, ()), method="reweight", check=True,
                     observations=obs)
    with pytest.raises(ValueError, match="was modified"):
        tg.pf_rejuvenate(torch.Generator(), st, tg.move_reweight,
                         (clobber, ()), method="reweight", check=True,
                         observations=obs)
    with pytest.raises(ValueError, match="not recognized"):
        tg.pf_rejuvenate(torch.Generator(), st, method="other")


# -- sub-state views --------------------------------------------------------

def _om_state():
    y_obs, _ = tom.synthesize_data(torch.Generator().manual_seed(42), 6, 3)
    model, x0, obs = tom.make_object_motion(6), tom.init_state("cpu"), \
        tom.obs_dense(y_obs)
    gen = torch.Generator().manual_seed(5)
    st = tg.pf_initialize(gen, model, (1, x0), obs, N)
    for t in range(1, 4):
        st = tg.pf_update(gen, st, (t + 1, x0), (tg.Extend(1), tg.NoChange()),
                          obs, check=False)
    return st, x0, obs


def _om_window_sel():
    steps = torch.arange(6)
    m = (steps == 2) | (steps == 3)
    return tg.Selection({("moving",): m, ("y",): m})


VERBS = {
    "update, plain model": (
        _state, lambda gen, s: tg.pf_update(
            gen, s, (torch.tensor(0.9),), (tg.UnknownChange(),))),
    "update, Extend on an Unfold": (
        lambda: _om_state()[0], lambda gen, s: tg.pf_update(
            gen, s, (5, tom.init_state("cpu")), (tg.Extend(1), tg.NoChange()),
            tom.obs_dense(tom.synthesize_data(
                torch.Generator().manual_seed(42), 6, 3)[0]), check=False)),
    "rejuvenate move, windowed mh": (
        lambda: _om_state()[0], lambda gen, s: tg.pf_rejuvenate(
            gen, s, tg.mh, (_om_window_sel(),), window=2)),
    "rejuvenate reweight, proposal": (
        _state, lambda gen, s: tg.pf_rejuvenate(
            gen, s, tg.move_reweight, (b_proposal, ()), 2,
            method="reweight")),
    "rejuvenate reweight, windowed selection": (
        lambda: _om_state()[0], lambda gen, s: tg.pf_rejuvenate(
            gen, s, tg.move_reweight, (_om_window_sel(),), window=2,
            method="reweight")),
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_verbs_on_sub_state_views(verb):
    make, run = VERBS[verb]
    st = make()
    idx = torch.arange(N // 4, N, 2)           # a strided half-ish view
    rest = torch.tensor([i for i in range(N) if i not in set(idx.tolist())])
    out = run(torch.Generator().manual_seed(9), st[idx])
    block = tg.ParticleFilterState(tree_take(st.traces, idx),
                                   st.log_weights[idx], st.log_ml_est,
                                   st.parents[idx])
    ref = run(torch.Generator().manual_seed(9), block)
    assert isinstance(out, tg.ParticleFilterState)
    assert out.n_particles == N
    # outside the view: bit-equal; inside: as the verb run on the block
    for a, b in zip(tree_leaves(tree_take(out.traces, rest)),
                    tree_leaves(tree_take(st.traces, rest))):
        assert a is b or torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert torch.equal(out.log_weights[rest], st.log_weights[rest])
    got = tree_leaves(tree_take(out.traces, idx))
    want = tree_leaves(ref.traces)
    shared = tree_leaves(st.traces)
    for a, b, s in zip(got, want, shared):
        if isinstance(s, torch.Tensor) and (s.dim() == 0 or s.shape[-1] != N
                                            and s.shape[0] != N):
            continue   # shared across particles: the source's value stays
        if not isinstance(s, torch.Tensor):
            continue
        assert torch.equal(a, b)
    assert torch.equal(out.log_weights[idx], ref.log_weights)
    assert torch.equal(out.parents, st.parents)
