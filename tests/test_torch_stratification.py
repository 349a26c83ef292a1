"""Stratification and stratified / custom-proposal initialize and update:
the port (genparticlefilters_tpu_torch/utils/stratification.py,
smc/initialize.py, smc/update.py) against the JAX package.

- ``stratum_assignment`` is index arithmetic where N is divisible by K:
  bit-equal to JAX in both layouts; the random tail is fed through the
  ``assignment_tail`` seam with JAX's own draws, and must then be
  bit-equal too.
- ``choiceproduct`` gives the same maps (addresses, values, dtypes), and
  ``ChoiceMap.merge`` (the right side wins where its mask is set) the same
  values and masks as JAX's, with ``is_empty``/``total_mask_any``.
- A plain batch-safe model whose every choice is fixed by strata and
  observations: stratified ``pf_initialize`` and then a stratified
  ``pf_update`` that adds structurally new sites give the same choices
  and weights as JAX (atol 1e-5, float32 log densities).
- With a proposal the draws differ between the frameworks, so the port's
  weights are held against their exact float64 value from its own traces
  (atol 1e-5).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.utils import stratification as jstrat  # noqa
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.utils import stratification as tstrat  # noqa

N = 12


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
@pytest.mark.parametrize("n,k", [(12, 3), (12, 4), (1000, 8), (7, 7)])
def test_assignment_bit_equal_when_divisible(layout, n, k):
    want = np.asarray(jstrat.stratum_assignment(jr.key(0), n, k, layout))
    got = tstrat.stratum_assignment(torch.Generator(), n, k, layout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
@pytest.mark.parametrize("n,k", [(13, 3), (100, 7), (5, 8)])
def test_assignment_tail_through_the_seam(layout, n, k):
    key = jr.key(3)
    want = np.asarray(jstrat.stratum_assignment(key, n, k, layout))
    rand = np.asarray(jr.randint(key, (n,), 0, k, dtype=jnp.int32))
    tail = rand[k * (n // k):].copy()
    got = tstrat.stratum_assignment(torch.Generator(), n, k, layout,
                                    assignment_tail=tail)
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tstrat.stratum_assignment(torch.Generator().manual_seed(1), n, k,
                                      layout)
    assert drawn.min() >= 0 and drawn.max() < k
    np.testing.assert_array_equal(drawn.numpy()[:k * (n // k)],
                                  want[:k * (n // k)])


def test_choiceproduct_matches_jax():
    spec = (("a", [0, 1, 2]), (("line", "b"), [False, True]),
            ("x", [0.5, -1.25]))
    want = jg.choiceproduct(*spec)
    got = tg.choiceproduct(*spec)
    assert len(got) == len(want) == 12
    for tc, jc in zip(got, want):
        assert list(tc.entries) == list(jc.entries)
        for k in jc.entries:
            a, b = np.asarray(tc[k]), np.asarray(jc[k])
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b)
    d = tg.choiceproduct({"a": [1, 2], "b": [3]})
    assert [int(c["a"]) for c in d] == [1, 2]


def test_merge_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4, 3)).astype(np.float32)
    ma = np.array([True, False, True, False])
    mb = np.array([False, False, True, True])
    left = [("p", a, True), ("q", a, ma), ("r", a, ma), ("s", a, True)]
    right = [("p", b, mb), ("q", b, mb), ("r", b, True), ("t", b, mb)]

    def build(lib, conv, spec):
        return lib.ChoiceMap({(k,): lib.Entry(conv(v), m if m is True
                                              else conv(m))
                              for k, v, m in spec})
    jm = build(jg, jnp.asarray, left).merge(build(jg, jnp.asarray, right))
    tm = build(tg, torch.from_numpy, left).merge(
        build(tg, torch.from_numpy, right))
    assert sorted(tm.entries) == sorted(jm.entries)
    for k, je in jm.entries.items():
        te = tm.entries[k]
        np.testing.assert_array_equal(te.value.numpy(), np.asarray(je.value))
        if je.mask is True:
            assert te.mask is True
        else:
            np.testing.assert_array_equal(np.asarray(te.mask),
                                          np.asarray(je.mask))
    assert tg.EMPTY.is_empty() and not tm.is_empty()
    assert bool(tm.total_mask_any())
    none_set = tg.ChoiceMap({("q",): tg.Entry(torch.zeros(4),
                                              torch.zeros(4, dtype=bool))})
    assert not bool(none_set.total_mask_any())
    assert tg.EMPTY.total_mask_any() is False


def _models():
    """The same model in both packages: a ~ U{0,1,2}, c ~ Bern(0.4),
    x ~ N(a + 0.5c, 1) and, from n = 2, b ~ Bern(0.3) and
    z ~ N(x + 2b, 0.5)."""
    @jg.gen
    def jmodel(n):
        a = jg.trace("a", jg.uniform_discrete(0, 2))
        c = jg.trace("c", jg.bernoulli(0.4))
        x = jg.trace("x", jg.normal(a + jnp.where(c, 0.5, 0.0), 1.0))
        if n >= 2:
            b = jg.trace("b", jg.bernoulli(0.3))
            jg.trace("z", jg.normal(x + jnp.where(b, 2.0, 0.0), 0.5))
        return x

    @tg.gen
    def tmodel(n):
        a = tg.trace("a", tg.uniform_discrete(0, 2))
        c = tg.trace("c", tg.bernoulli(0.4))
        x = tg.trace("x", tg.normal(a + torch.where(c, 0.5, 0.0), 1.0))
        if n >= 2:
            b = tg.trace("b", tg.bernoulli(0.3))
            tg.trace("z", tg.normal(x + torch.where(b, 2.0, 0.0), 0.5))
        return x

    jmodel.batch_safe = tmodel.batch_safe = True
    return jmodel, tmodel


def _choices(lib, state, addrs):
    return [np.asarray(lib.batched_choice(state, a)) for a in addrs]


@pytest.mark.parametrize("layout", ["contiguous", "interleaved"])
def test_stratified_initialize_then_update_match_jax(layout):
    jmodel, tmodel = _models()
    strata = (("a", [0, 1, 2]), ("c", [False, True]))
    jst = jg.pf_initialize(jr.key(0), jmodel, (1,), jg.choicemap(("x", 0.7)),
                           N, strata=jg.choiceproduct(*strata),
                           layout=layout)
    tst = tg.pf_initialize(torch.Generator(), tmodel, (1,),
                           tg.choicemap(("x", 0.7)), N,
                           strata=tg.choiceproduct(*strata), layout=layout)
    for a, b in zip(_choices(tg, tst, ("a", "c")),
                    _choices(jg, jst, ("a", "c"))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tst.log_weights.numpy(),
                               np.asarray(jst.log_weights), atol=1e-5)

    # a stratified update that adds the structurally new sites b and z
    bstrata = (("b", [False, True]),)
    jst2 = jg.pf_update(jr.key(1), jst, (2,), (jg.UnknownChange(),),
                        jg.choicemap(("z", 1.5)),
                        strata=jg.choiceproduct(*bstrata), layout=layout)
    tst2 = tg.pf_update(torch.Generator(), tst, (2,), (tg.UnknownChange(),),
                        tg.choicemap(("z", 1.5)),
                        strata=tg.choiceproduct(*bstrata), layout=layout)
    np.testing.assert_array_equal(*(_choices(lib, s, ("b",))[0]
                                    for lib, s in ((tg, tst2), (jg, jst2))))
    np.testing.assert_allclose(tst2.log_weights.numpy(),
                               np.asarray(jst2.log_weights), atol=1e-5)
    np.testing.assert_allclose(tst2.traces.score.numpy(),
                               np.asarray(jst2.traces.score), atol=1e-5)


def _lp_normal(x, mu, s):
    return -0.5 * ((x - mu) / s) ** 2 - math.log(s) - 0.5 * math.log(
        2 * math.pi)


def _lp_bern(v, p):
    return math.log(p) if v else math.log(1 - p)


@pytest.mark.parametrize("stratified", [False, True])
def test_initialize_with_proposal_exact_weights(stratified):
    _, tmodel = _models()

    @tg.gen
    def q():
        tg.trace("c", tg.bernoulli(0.9))

    q.batch_safe = True
    strata = tg.choiceproduct(("a", [0, 1, 2])) if stratified else None
    st = tg.pf_initialize(torch.Generator().manual_seed(5), tmodel, (1,),
                          tg.choicemap(("x", 0.7)), N, proposal=q,
                          proposal_args=(), strata=strata)
    a, c = _choices(tg, st, ("a", "c"))
    if stratified:
        np.testing.assert_array_equal(a, np.repeat([0, 1, 2], N // 3))
    for i in range(N):
        want = (_lp_bern(c[i], 0.4) + _lp_normal(0.7, a[i] + 0.5 * c[i], 1.0)
                - _lp_bern(c[i], 0.9)
                + (math.log(1 / 3) + math.log(3) if stratified else 0.0))
        np.testing.assert_allclose(float(st.log_weights[i]), want, atol=1e-5)
