"""Config 4, tempered SMC: the port (genparticlefilters_tpu_torch/models/
tempered.py, smc/algorithms.py ``tempered_smc``) against the JAX package.

- A JAX state carried across by ``interop`` (and back, bit-equal): the
  args-update weights to a new temperature agree with JAX's within 1e-5.
- ``tempered_log_z`` (float64 quadrature) agrees with JAX's float32 one.
- ``run_tempered_smc`` at N=4000: LML within 0.1 of the quadrature, both
  modes populated, the weight near the modes (the checks of
  tests/test_models.py).
- The SMCP³ loop (``tempered_smc``'s loop with the args-update replaced
  by ``pf_update(translator=...)``: eps ~ N(0, 0.25) forward and
  backward, x' = x + eps), written out in both packages, at N=4000 over
  4 seeds each: the mean LMLs agree within 6·(combined stderr) + 0.05.
  (The random-walk move leaves the weights far from uniform, so at this
  N both sit well below log Z: the log of an unbiased estimate.)
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import tempered as jtm  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from genparticlefilters_tpu_torch.models import tempered as ttm  # noqa

N = 4000


def test_args_update_weights_of_a_carried_state():
    n = 256
    jst = jg.pf_initialize(jr.key(0), jtm.make_tempered_model(),
                           (jnp.float32(0.3),), jg.EMPTY, n)
    leaves = [np.array(x) for x in jax.tree_util.tree_flatten(jst)[0]]
    assert len(leaves) == 8
    tmodel = ttm.make_tempered_model()
    tst = state_from_numpy(tmodel, leaves, (torch.tensor(0.3),), tg.EMPTY,
                           device="cpu")
    for a, b in zip(state_to_numpy(tst), leaves):
        np.testing.assert_array_equal(a, b)
    jst2 = jg.pf_update(jr.key(1), jst, (jnp.float32(0.7),),
                        (jg.UnknownChange(),), jg.EMPTY)
    tst2 = tg.pf_update(torch.Generator(), tst, (torch.tensor(0.7),),
                        (tg.UnknownChange(),), tg.EMPTY)
    np.testing.assert_allclose(tst2.log_weights.numpy(),
                               np.asarray(jst2.log_weights), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tg.batched_choice(tst2, "x").numpy(),
                                  np.asarray(jg.batched_choice(jst2, "x")))


def test_log_z_matches_jax():
    assert abs(ttm.tempered_log_z() - float(jtm.tempered_log_z())) < 1e-4


def _check_modes(state):
    xs = tg.batched_choice(state, "x").numpy()
    w = tg.get_norm_weights(state).numpy()
    assert w[xs < 0].sum() > 0.05 and w[xs >= 0].sum() > 0.05
    near = (np.abs(xs[:, None] - np.array(ttm.MODES)) < 1.2).any(axis=1)
    assert w[near].sum() > 0.95


def test_tempered_smc_lml_and_modes():
    state, lml = ttm.run_tempered_smc(torch.Generator().manual_seed(3), N)
    assert abs(float(lml) - ttm.tempered_log_z()) < 0.1
    _check_modes(state)


def _smcp3_parts(lib):
    @lib.gen
    def fwd(tr):
        lib.trace("eps", lib.normal(0.0, 0.25))

    @lib.gen
    def bwd(tr):
        lib.trace("eps", lib.normal(0.0, 0.25))

    fwd.batch_safe = bwd.batch_safe = True

    def shift(prev, f):
        eps = f[("eps",)]
        return (lib.ChoiceMap({("x",): lib.Entry(prev[("x",)] + eps, True)}),
                lib.ChoiceMap({("eps",): lib.Entry(-eps, True)}))

    def translator(beta):
        return lib.UpdatingTraceTranslator(
            p_new_args=(beta,), p_argdiffs=(lib.UnknownChange(),),
            q_forward=fwd, q_backward=bwd,
            transform=lib.TraceTransform(shift))
    return translator


def smcp3_loop(gen, n, n_temps):
    """tempered_smc's loop with the args-update replaced by an SMCP³
    translator (the loop of scripts/config45_bench.py with the ESS trigger
    kept)."""
    translator = _smcp3_parts(tg)
    betas = torch.linspace(0.0, 1.0, n_temps) ** 2
    st = tg.pf_initialize(gen, ttm.make_tempered_model(), (betas[0],),
                          tg.EMPTY, n)
    for i in range(1, n_temps):
        if bool(tg.effective_sample_size(st) < 0.75 * n):
            st = tg.pf_resample(gen, st, "systematic", check=False)
        st = tg.pf_update(gen, st, translator=translator(betas[i]),
                          check=False)
    return st


def _jax_smcp3_loop(key, n, n_temps):
    translator = _smcp3_parts(jg)
    betas = jnp.linspace(0.0, 1.0, n_temps) ** 2
    st = jg.pf_initialize(key, jtm.make_tempered_model(), (betas[0],),
                          jg.EMPTY, n)
    for i in range(1, n_temps):
        k = jr.fold_in(key, i)
        if float(jg.effective_sample_size(st)) < 0.75 * n:
            st = jg.pf_resample(jr.fold_in(k, 1), st, "systematic",
                                check=False)
        st = jg.pf_update(k, st, translator=translator(betas[i]),
                          check=False)
    return float(jg.log_ml_estimate(st))


def test_smcp3_loop_lml_matches_jax():
    seeds = 4
    jl = [_jax_smcp3_loop(jr.key(s), N, 50) for s in range(seeds)]
    tl = [float(tg.log_ml_estimate(smcp3_loop(
        torch.Generator().manual_seed(s), N, 50))) for s in range(seeds)]
    se = math.sqrt(np.var(jl) / seeds + np.var(tl) / seeds)
    assert abs(np.mean(tl) - np.mean(jl)) < 6 * se + 0.05, (tl, jl)
    assert abs(np.mean(tl) - ttm.tempered_log_z()) < 0.4
