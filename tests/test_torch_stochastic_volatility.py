"""Config 3, the stochastic-volatility filter with move-reweight
rejuvenation: the port (genparticlefilters_tpu_torch/models/
stochastic_volatility.py) against the JAX package.

- ``generate`` with every h and y constrained to the same numpy values:
  weights and scores within 1e-5 of JAX plus 2e-7 relative (a float32
  sum of 2T log densities: one ulp is 1.5e-5 at |w| = 150) and the
  packed store bit-equal.
- A JAX filter state carried across by ``interop`` and back is bit-equal,
  and the port's own filter state has JAX's leaf shapes and dtypes.
- The filter's LML at N=4000, T=20 over 4 seeds against JAX's over 4
  seeds: the means agree within 6·(combined stderr) + 0.05.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.core.gfi import (  # noqa: E402
    batched_interpretation as jbatched)
from genparticlefilters_tpu.models import stochastic_volatility as jsv  # noqa
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    stochastic_volatility as tsv)

P = jsv.SVParams()
TP = tsv.SVParams()
T = 20


def _y():
    return np.array(jsv.synthesize_sv_data(jr.key(1), T, P))


def test_generate_fully_constrained_matches_jax():
    n = 64
    rng = np.random.default_rng(0)
    h = np.zeros((T, n), np.float32)
    h[0] = P.mu + 0.96 * rng.normal(size=n)
    for t in range(1, T):
        h[t] = P.mu + P.phi * (h[t - 1] - P.mu) + P.sigma * rng.normal(size=n)
    y = _y()
    jcm = jg.ChoiceMap({("h",): jg.Entry(jnp.asarray(h), True),
                        ("y",): jg.Entry(jnp.asarray(y), True)})
    tcm = tg.ChoiceMap({("h",): tg.Entry(torch.from_numpy(h), True),
                        ("y",): tg.Entry(torch.from_numpy(y), True)})
    with jbatched(n):
        jtr, jw = jsv.make_sv_model(T, P).generate(
            jr.key(0), (T, jnp.float32(P.mu)), jcm)
    with tg.batched_interpretation(n):
        ttr, tw = tsv.make_sv_model(T, TP).generate(
            torch.Generator(), (T, torch.tensor(P.mu)), tcm)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5,
                               rtol=2e-7)
    np.testing.assert_allclose(ttr.score.numpy(), np.asarray(jtr.score),
                               atol=1e-5, rtol=2e-7)
    np.testing.assert_array_equal(ttr.inner["store"].mat.numpy(),
                                  np.asarray(jtr.inner["store"].mat))


def test_interop_round_trip_and_leaf_layout():
    y = _y()
    n, t_max = 256, 8
    jst = jsv.sv_particle_filter(jr.key(2), jnp.asarray(y[:t_max]), n,
                                 t_max, P)
    leaves = [np.array(x) for x in jax.tree_util.tree_flatten(jst)[0]]
    assert len(leaves) == 10
    tmodel = tsv.make_sv_model(t_max, TP)
    tobs = tsv.sv_obs_dense(torch.from_numpy(y[:t_max]))
    tst = state_from_numpy(tmodel, leaves, (1, torch.tensor(P.mu)), tobs,
                           device="cpu")
    back = state_to_numpy(tst)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tst.traces.inner["t"] == t_max
    assert tuple(tst.traces.inner["store"].mat.shape) == (2 * t_max, n)
    own = tsv.sv_particle_filter(torch.Generator().manual_seed(0),
                                 torch.from_numpy(y[:t_max]), n, t_max, TP)
    for a, b in zip(state_to_numpy(own), leaves):
        assert (a.dtype, a.shape) == (b.dtype, b.shape)


def test_filter_lml_matches_jax_over_seeds():
    n, seeds = 4000, 4
    y = _y()
    jf = jax.jit(jsv.sv_particle_filter, static_argnums=(2, 3))
    jl = [float(jg.log_ml_estimate(jf(jr.key(10 + s), jnp.asarray(y), n, T,
                                      P))) for s in range(seeds)]
    tl = []
    for s in range(seeds):
        st = tsv.sv_particle_filter(torch.Generator().manual_seed(20 + s),
                                    torch.from_numpy(y), n, T, TP)
        assert bool(torch.isfinite(st.log_weights).all())
        ess = float(tg.effective_sample_size(st))
        assert 1.0 <= ess <= n
        assert float(tg.var(st, (T - 1, "h"))) > 0
        tl.append(float(tg.log_ml_estimate(st)))
    se = math.sqrt(np.var(jl) / seeds + np.var(tl) / seeds)
    assert abs(np.mean(tl) - np.mean(jl)) < 6 * se + 0.05, (tl, jl)
