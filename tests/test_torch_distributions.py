"""Primitive distributions (genparticlefilters_tpu_torch/core/
distributions.py): ``UniformDiscrete`` against the JAX package's, the
fill-kernel scalar path of ``_f`` against ``torch.as_tensor``, the
batched draw of parameters shared across particles, and ``Factor``
against the JAX package's; then the fifteen others: ``log_prob`` against
the JAX package's on the same numpy values and against scipy, 200K draws
of ``sample_batched`` against closed-form moments, event shapes, and no
Python-number parameter turned into a tensor by a host copy."""

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


# ---------------------------------------------------------------------------
# The 15 distributions after normal, bernoulli, uniform_discrete and factor
# ---------------------------------------------------------------------------

from scipy import stats  # noqa: E402

_R = np.random.default_rng(11)
_LOC3 = np.array([0.5, -1.0, 2.0], np.float32)
_COV3 = np.array([[2.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 0.5]],
                 np.float32)
_LOGITS = np.array([0.2, -1.0, 1.5, 0.0], np.float32)
_LABELS = np.array([3, 7, 11], np.int32)
_PROBS = np.array([0.2, 0.5, 0.3], np.float32)


def _mvn_values():
    return _R.normal(size=(6, 3)).astype(np.float32)


# name -> (constructor args, values to score, scipy log-density or None,
#          draw moments: (mean, var) per event element, or "cauchy")
CASES = {
    "uniform": ((-1.0, 3.0), np.array([-2.0, -1.0, 0.3, 2.9, 3.0, 3.5],
                                       np.float32),
                lambda v: stats.uniform(-1.0, 4.0).logpdf(v), (1.0, 16 / 12)),
    "categorical": ((_LOGITS,), np.array([0, 1, 2, 3, -1, 4], np.int32),
                    None, None),
    "labeled_categorical": ((_LABELS, _PROBS), np.array([3, 7, 11, 5],
                                                          np.int32),
                            None, None),
    "poisson": ((3.5,), np.array([0, 1, 3, 7, 12, -1], np.int32),
                lambda v: stats.poisson(3.5).logpmf(v), (3.5, 3.5)),
    "gamma": ((2.5, 1.5), np.array([0.1, 1.0, 3.7, 9.0, -0.5], np.float32),
              lambda v: stats.gamma(2.5, scale=1.5).logpdf(v),
              (3.75, 2.5 * 1.5 ** 2)),
    "beta": ((2.0, 5.0), np.array([0.05, 0.2, 0.5, 0.9, 1.2], np.float32),
             lambda v: stats.beta(2.0, 5.0).logpdf(v),
             (2 / 7, 10 / (49 * 8))),
    "exponential": ((1.7,), np.array([0.0, 0.3, 2.0, 5.0, -0.1],
                                       np.float32),
                    lambda v: stats.expon(scale=1 / 1.7).logpdf(v),
                    (1 / 1.7, 1 / 1.7 ** 2)),
    "geometric": ((0.3,), np.array([0, 1, 4, 10, -1], np.int32),
                  lambda v: stats.geom(0.3).logpmf(v + 1),
                  (0.7 / 0.3, 0.7 / 0.09)),
    "lognormal": ((0.2, 0.5), np.array([0.3, 1.0, 2.5, 6.0], np.float32),
                  lambda v: stats.lognorm(0.5, scale=math.exp(0.2)).logpdf(v),
                  (math.exp(0.2 + 0.125),
                   (math.exp(0.25) - 1) * math.exp(0.4 + 0.25))),
    "laplace": ((0.5, 1.5), np.array([-3.0, 0.0, 0.5, 4.0], np.float32),
                lambda v: stats.laplace(0.5, 1.5).logpdf(v),
                (0.5, 2 * 1.5 ** 2)),
    "cauchy": ((1.0, 2.0), np.array([-10.0, 0.0, 1.0, 3.0], np.float32),
               lambda v: stats.cauchy(1.0, 2.0).logpdf(v), "cauchy"),
    "student_t": ((5.0, 1.0, 2.0), np.array([-4.0, 0.0, 1.0, 6.0],
                                             np.float32),
                  lambda v: stats.t(5.0, 1.0, 2.0).logpdf(v),
                  (1.0, 4.0 * 5 / 3)),
    "mvnormal_diag": ((_LOC3, np.array([0.5, 1.0, 2.0], np.float32)),
                      _mvn_values(),
                      lambda v: stats.multivariate_normal(
                          _LOC3, np.diag([0.25, 1.0, 4.0])).logpdf(v),
                      (_LOC3, np.array([0.25, 1.0, 4.0]))),
    "mvnormal": ((_LOC3, _COV3), _mvn_values(),
                 lambda v: stats.multivariate_normal(_LOC3, _COV3).logpdf(v),
                 (_LOC3, np.diag(_COV3))),
    "delta": ((1.5,), np.array([1.5, 1.0, 2.0], np.float32), None,
              (1.5, 0.0)),
}


def _ctor(lib, name, args, tensors):
    conv = ((lambda a: torch.from_numpy(a)) if lib is td
            else (lambda a: jnp.asarray(a)))
    return getattr(lib, name)(*[conv(a) if isinstance(a, np.ndarray) else a
                                for a in args])


@pytest.mark.parametrize("name", list(CASES))
def test_log_prob_matches_jax_and_scipy(name):
    args, vals, ref, _ = CASES[name]
    got = _ctor(td, name, args, True).log_prob(torch.from_numpy(vals))
    jdist = _ctor(jd, name, args, True)
    # the JAX package's categorical and full-covariance normal score one
    # event at a time (a batch of values against shared parameters raises
    # there), so they are held value by value
    want = np.array([np.asarray(jdist.log_prob(jnp.asarray(v)))
                     for v in vals], np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if ref is not None:
        np.testing.assert_allclose(got.numpy(), ref(vals.astype(np.float64)),
                                   rtol=1e-4, atol=1e-4)


def test_categorical_log_prob_exact():
    lz = np.log(np.exp(_LOGITS.astype(np.float64)).sum())
    got = td.categorical(torch.from_numpy(_LOGITS)).log_prob(
        torch.tensor([0, 2, 4], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got[:2], _LOGITS[[0, 2]] - lz, atol=1e-5)
    assert got[2] == -np.inf
    got = td.labeled_categorical(torch.from_numpy(_LABELS),
                                 torch.from_numpy(_PROBS)).log_prob(
        torch.tensor([7, 5], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got[0], math.log(0.5), atol=1e-6)
    assert got[1] == -np.inf


N_DRAWS = 200_000


@pytest.mark.parametrize("name", list(CASES))
def test_sampling_moments(name):
    """``sample_batched`` draws [N, ...event] from an explicit generator:
    their mean and variance within 6 standard errors of the closed form
    (Cauchy: median and interquartile range; the categoricals:
    frequencies)."""
    args, _, _, moments = CASES[name]
    gen = torch.Generator().manual_seed(5)
    d = _ctor(td, name, args, True)
    x = d.sample_batched(gen, N_DRAWS)
    assert x.shape[0] == N_DRAWS
    if name == "categorical":
        p = np.exp(_LOGITS) / np.exp(_LOGITS).sum()
        f = np.bincount(x.numpy(), minlength=4) / N_DRAWS
        assert np.all(np.abs(f - p) < 6 * np.sqrt(p * (1 - p) / N_DRAWS))
        return
    if name == "labeled_categorical":
        f = np.array([(x.numpy() == lab).mean() for lab in _LABELS])
        assert np.all(np.abs(f - _PROBS)
                      < 6 * np.sqrt(_PROBS * (1 - _PROBS) / N_DRAWS))
        return
    x = x.double().numpy()
    if moments == "cauchy":
        q1, med, q3 = np.quantile(x, [0.25, 0.5, 0.75])
        # a quantile's stderr: sqrt(p(1-p)/n) / density there
        se = math.sqrt(0.25 * 0.75 / N_DRAWS) / stats.cauchy(1.0, 2.0).pdf(3.0)
        assert abs(med - 1.0) < 6 * se and abs((q3 - q1) - 4.0) < 12 * se
        return
    mean, var = (np.asarray(m, np.float64) for m in moments)
    m_se = np.sqrt(np.maximum(var, 1e-30) / N_DRAWS)
    assert np.all(np.abs(x.mean(0) - mean) < 6 * m_se + 1e-6), x.mean(0)
    v = x.var(0)
    v_se = np.sqrt(np.maximum(((x - x.mean(0)) ** 4).mean(0) - v ** 2,
                              1e-30) / N_DRAWS)
    assert np.all(np.abs(v - var) < 6 * v_se + 1e-6), v


def test_event_shapes_and_particle_axis():
    gen = torch.Generator().manual_seed(0)
    for d in (td.mvnormal_diag(torch.zeros(3), torch.ones(3)),
              td.mvnormal(torch.zeros(3), torch.eye(3))):
        assert tuple(d.batch_shape()) == ()
        assert tuple(d.sample(gen).shape) == (3,)
        assert tuple(d.sample_batched(gen, 7).shape) == (7, 3)
        assert tuple(d.log_prob(torch.zeros(7, 3)).shape) == (7,)
    c = td.categorical(torch.zeros(5, 4))
    assert tuple(c.sample_batched(gen, 5).shape) == (5,)
    assert tuple(c.sample_batched(gen, 6).shape) == (6, 5)
    assert c.sample(gen).dtype == torch.int32


class _HostCopies(torch.overrides.TorchFunctionMode):
    """Records a Python number turned into a tensor by ``torch.tensor`` or
    ``torch.as_tensor``: on the card that copy waits for the device queue
    (a host sync), where ``torch.full`` is a fill kernel."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.tensor, torch.as_tensor) and args and isinstance(
                args[0], (bool, int, float)):
            self.calls.append((func.__name__, args[0]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(CASES) + ["normal", "bernoulli",
                                                "uniform_discrete"])
def test_no_parameter_makes_a_host_copy(name):
    if name in CASES:
        args, vals, _, _ = CASES[name]
    else:
        args = {"normal": (0.5, 2.0), "bernoulli": (0.3,),
                "uniform_discrete": (0, 4)}[name]
        vals = np.array([0.0, 1.0], np.float32)
    d = _ctor(td, name, args, True)
    value = torch.from_numpy(vals)
    gen = torch.Generator().manual_seed(0)
    with _HostCopies() as mode:
        d.sample_batched(gen, 5)
        d.log_prob(value)
    assert not mode.calls, mode.calls
