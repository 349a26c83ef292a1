"""Weighted statistics (genparticlefilters_tpu_torch/smc/statistics.py)
against the JAX package on the same state: a JAX object-motion state
carried into the port. The values are bit-equal, so only the float32
weighted sums differ in association: atol 1e-5."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import object_motion as jom  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.interop import state_from_numpy  # noqa
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    object_motion as tom)

N, T = 512, 6


@pytest.fixture(scope="module")
def states():
    y_obs, _ = jom.synthesize_data(jr.key(42), T, 2)
    jst = jg.pf_initialize(jr.key(3), jom.make_object_motion(T),
                           (4, jom.init_state()), jom.obs_dense(y_obs), N)
    tst = state_from_numpy(
        tom.make_object_motion(T),
        [np.array(x) for x in jax.tree_util.tree_flatten(jst)[0]],
        (4, tom.init_state("cpu")), tom.obs_dense(torch.from_numpy(
            np.array(y_obs))), device="cpu")
    return jst, tst


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=1e-5, rtol=0)


@pytest.mark.parametrize("stat", ["mean", "var"])
def test_mean_var_forms_match_jax(states, stat):
    jst, tst = states
    jf, tf = getattr(jg, stat), getattr(tg, stat)
    for t in range(4):
        _close(tf(tst, (t, "y")), jf(jst, (t, "y")))
        _close(tf(tst, (t, "moving")), jf(jst, (t, "moving")))
    # a function of several addresses
    _close(tf(tst, (1, "y"), lambda a, b: a * b, (3, "y")),
           jf(jst, (1, "y"), lambda a, b: a * b, (3, "y")))
    # the return value (the stacked carries, a tuple), and a function of it
    for a, b in zip(tf(tst), jf(jst)):
        _close(a, b)
    _close(tf(tst, fn=lambda rv: rv[0][:, 2]),
           jf(jst, fn=lambda rv: rv[0][:, 2]))


def test_proportionmap_matches_jax(states):
    jst, tst = states
    for addr in ((1, "moving"), (3, "moving")):
        got = tg.proportionmap(tst, addr)
        ref = jg.proportionmap(jst, addr)
        assert set(got) == set(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) < 1e-5
    # sub-state views read their block's weights
    sub = tst[0:100]
    got = tg.proportionmap(sub, (3, "moving"))
    assert abs(sum(got.values()) - 1.0) < 1e-5
    _close(tg.mean(sub, (2, "y")), jg.mean(jst[0:100], (2, "y")))
