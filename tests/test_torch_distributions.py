"""Primitive distributions (genparticlefilters_tpu_torch/core/
distributions.py): ``UniformDiscrete`` against the JAX package's, the
fill-kernel scalar path of ``_f`` against ``torch.as_tensor``, the
batched draw of parameters shared across particles, and ``Factor``
against the JAX package's."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from genparticlefilters_tpu.core import distributions as jd  # noqa: E402
from genparticlefilters_tpu_torch.core import distributions as td  # noqa


@pytest.mark.parametrize("lo,hi", [(0, 3), (-2, 2), (5, 5)])
def test_uniform_discrete_log_prob_matches_jax(lo, hi):
    v = np.arange(lo - 2, hi + 3, dtype=np.int32)
    ref = np.asarray(jd.uniform_discrete(lo, hi).log_prob(jnp.asarray(v)))
    got = td.uniform_discrete(lo, hi).log_prob(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, ref)
    # tensor bounds, broadcast against a batch of values (the MOT-DA site)
    los = np.zeros((3,), np.int32)
    vals = np.random.default_rng(0).integers(-1, 4, (5, 3)).astype(np.int32)
    ref = np.asarray(jd.uniform_discrete(jnp.asarray(los), 2).log_prob(
        jnp.asarray(vals)))
    got = td.uniform_discrete(torch.from_numpy(los), 2).log_prob(
        torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_uniform_discrete_draws():
    gen = torch.Generator().manual_seed(0)
    d = td.uniform_discrete(torch.zeros((3,), dtype=torch.int32), 2)
    x = d.sample_batched(gen, 20000)
    assert x.dtype == torch.int32 and tuple(x.shape) == (20000, 3)
    counts = torch.bincount(x.reshape(-1).long(), minlength=3).numpy()
    assert counts.sum() == 60000 and (counts > 0).all()
    # each value ~ 1/3: within 6 binomial sds
    assert np.all(np.abs(counts / 60000 - 1 / 3)
                  < 6 * math.sqrt(2 / 9 / 60000))
    y = td.uniform_discrete(-1, 1).sample_batched(gen, 1000)
    assert tuple(y.shape) == (1000,) and int(y.min()) == -1 \
        and int(y.max()) == 1


@pytest.mark.parametrize("x", [0.5, 0.3, 1, True, 2.0 * math.pi, 1e-40,
                               -7.25])
def test_f_fill_is_bit_identical_to_as_tensor(x):
    got = td._f(x, torch.device("cpu"))
    ref = torch.as_tensor(x, dtype=torch.float32, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.view(torch.int32).item() == ref.view(torch.int32).item()
    t = torch.tensor([1.5, 2.5])
    assert torch.equal(td._f(t, None), t)


def test_shared_parameters_get_a_particle_axis():
    gen = torch.Generator().manual_seed(1)
    loc = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    x = td.normal(loc, 0.01).sample_batched(gen, 7)
    assert tuple(x.shape) == (7, 4, 2)
    assert torch.allclose(x.mean(0), loc, atol=0.05)
    # parameters already carrying the particle axis keep their shape
    y = td.normal(torch.zeros(7, 4, 2), 1.0).sample_batched(gen, 7)
    assert tuple(y.shape) == (7, 4, 2)


@pytest.mark.parametrize("logw", [-1.25, 3, np.array([0.5, -2.0, 7.125],
                                                        np.float32)])
def test_factor_matches_jax(logw):
    jf = jd.factor(jnp.asarray(logw) if isinstance(logw, np.ndarray)
                   else logw)
    tf = td.factor(torch.from_numpy(logw) if isinstance(logw, np.ndarray)
                   else logw)
    shape = np.shape(logw)
    ref_lp = np.asarray(jf.log_prob(jnp.zeros(shape)))
    got_lp = tf.log_prob(torch.zeros(shape))
    assert got_lp.dtype == torch.float32
    np.testing.assert_array_equal(got_lp.numpy(), ref_lp)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tf.sample(gen), torch.zeros(shape))
    # batched: a shared logw gets the particle axis; a [b] one keeps it
    b = 3 if shape == () else shape[0]
    x = tf.sample_batched(gen, b)
    assert x.dtype == torch.float32 and tuple(x.shape) == (b,)
    assert not x.any()
