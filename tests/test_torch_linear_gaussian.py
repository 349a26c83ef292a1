"""The linear-Gaussian SSM, BASELINE config 2
(genparticlefilters_tpu_torch/models/linear_gaussian.py and the filter loop
smc/algorithms.py), against the JAX package and the exact Kalman filter.

(a) make_lgssm's generate with every site constrained: the packed store,
    the shared observations and the carry are bit-equal to JAX's, the
    scores and weights agree to atol 1e-5 (float32 log densities).
(b) kalman_filter (numpy float64) against the JAX package's.
(c) lgssm_particle_filter at N=10,000, T=8 against the Kalman filter, with
    the tolerances of tests/test_models.py: filtering mean at T-1 within
    0.05·sd + 0.02, LML within 0.05 (means over 3 seeds), variance within
    rtol 0.2.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.config import use_check_batched_layout  # noqa
from genparticlefilters_tpu.models import linear_gaussian as jlg  # noqa
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    linear_gaussian as tlg)

T = 8


def test_generate_matches_jax():
    n = 64
    p = tlg.LGParams()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, n)).astype(np.float32)
    y = rng.normal(size=T).astype(np.float32)
    jcm = jg.ChoiceMap({("x",): jg.Entry(jnp.asarray(x), True),
                        ("y",): jg.Entry(jnp.asarray(y), True)})
    # per-particle [T, N] constraints have no per-particle reading, so
    # JAX's layout self-check is off for this call
    with use_check_batched_layout(False):
        with jg.core.gfi.batched_interpretation(n):
            jtr, jw = jlg.make_lgssm(T, jlg.LGParams()).generate(
                jr.key(0), (T, jnp.asarray(0.0, jnp.float32)), jcm)
    tcm = tg.ChoiceMap({("x",): tg.Entry(torch.from_numpy(x), True),
                        ("y",): tg.Entry(torch.from_numpy(y), True)})
    with tg.batched_interpretation(n):
        ttr, tw = tlg.make_lgssm(T, p).generate(
            torch.Generator(), (T, torch.zeros(())), tcm)
    a = [np.asarray(l) for l in jax.tree_util.tree_leaves(jtr)]
    b = tree_leaves(ttr)
    assert len(a) == len(b)
    score = 2   # leaf order: args t, args x0, score, carry, mat, y, t
    for i, (ja, tb) in enumerate(zip(a, b)):
        tb = tb.numpy() if isinstance(tb, torch.Tensor) else np.asarray(tb)
        assert tb.shape == ja.shape, i
        if i == score:
            np.testing.assert_allclose(tb, ja, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(tb, ja.astype(tb.dtype),
                                          err_msg=f"leaf {i}")
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ttr.get_choices()[("x",)].numpy(), x)


def test_kalman_filter_matches_jax():
    p = tlg.LGParams()
    y = np.random.default_rng(1).normal(0.0, 2.0, T).astype(np.float32)
    mus, vars_, lml = tlg.kalman_filter(y, p)
    jm, jv, jl = jlg.kalman_filter(jnp.asarray(y), jlg.LGParams())
    np.testing.assert_allclose(mus, np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(vars_, np.asarray(jv), atol=1e-6)
    assert abs(lml - float(jl)) < 1e-4


@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_lgssm_matches_kalman(method):
    p = tlg.LGParams()
    y_obs = tlg.synthesize_lg_data(torch.Generator().manual_seed(0), T, p)
    assert y_obs.shape == (T,)
    mus, vars_, lml_exact = tlg.kalman_filter(y_obs.numpy(), p)
    ests, lmls = [], []
    for s in range(3):
        st = tlg.lgssm_particle_filter(torch.Generator().manual_seed(10 + s),
                                       y_obs, 10_000, T, p, method)
        assert st.traces.inner["t"] == T
        ests.append(float(tg.mean(st, (T - 1, "x"))))
        lmls.append(float(tg.log_ml_estimate(st)))
    sd = math.sqrt(float(vars_[-1]))
    np.testing.assert_allclose(np.mean(ests), mus[-1], atol=0.05 * sd + 0.02)
    np.testing.assert_allclose(np.mean(lmls), lml_exact, atol=0.05)
    st = tlg.lgssm_particle_filter(torch.Generator().manual_seed(20), y_obs,
                                   10_000, T, p, method)
    np.testing.assert_allclose(float(tg.var(st, (T - 1, "x"))), vars_[-1],
                               rtol=0.2)
