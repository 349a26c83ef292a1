"""Primitive distributions: ``logpdf`` and batched sampling on tensors.

Parameters may be Python numbers or float32 tensors (a per-particle ``[N]``
tensor, or a shared one). Everything runs in float32, as the JAX package
does with x64 off: a Python constant enters as a float32 tensor on the
device of the value it meets, by a fill kernel (no host sync). Every draw
comes from the explicit ``torch.Generator`` it is given — uniforms,
normals, ``torch.poisson`` and ``torch._standard_gamma`` (Beta and
Student's t are built from gammas) — never from ``torch.distributions``,
whose samplers take no generator. Distributions with an event dimension
(``Categorical``'s logits, the multivariate normals) keep it last: it is
not part of ``batch_shape``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

__all__ = [
    "Distribution", "Normal", "normal", "Bernoulli", "bernoulli",
    "UniformDiscrete", "uniform_discrete", "Uniform", "uniform",
    "Categorical", "categorical", "LabeledCategorical",
    "labeled_categorical", "Poisson", "poisson", "Gamma", "gamma", "Beta",
    "beta", "Exponential", "exponential", "Geometric", "geometric",
    "LogNormal", "lognormal", "Laplace", "laplace", "Cauchy", "cauchy",
    "StudentT", "student_t", "MvNormalDiag", "mvnormal_diag", "MvNormal",
    "mvnormal", "Delta", "delta", "Factor", "factor"]


def _f(x, device):
    """``x`` as float32 on ``device``. A Python number enters by a fill
    kernel: ``torch.as_tensor`` would copy it from pageable host memory,
    which waits for the device queue (a host sync per parameter)."""
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _i(x, device):
    """``x`` as int32 on ``device`` (Python ints by a fill kernel)."""
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int32, device=device)
    return torch.as_tensor(x, device=device).to(torch.int32)


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(
        np.shape(x))


def _bshape(*xs):
    return torch.broadcast_shapes(*[_shape(x) for x in xs])


def _neg_inf(dev):
    return torch.full((), -math.inf, dtype=torch.float32, device=dev)


def _zero(dev):
    return torch.zeros((), dtype=torch.float32, device=dev)


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return x.device
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


class Distribution:
    """Base class: ``sample_batched(gen, batch)`` draws a leading particle
    axis of size ``batch`` from one generator; ``log_prob`` is elementwise
    over the batch shape (reduced over the event dims)."""

    def batch_shape(self) -> tuple:
        raise NotImplementedError

    def _draw_shape(self, b: int):
        """The batched-draw shape: params whose leading dim equals ``b``
        already carry the particle axis; shared params (any other shape,
        e.g. a ``[K, 2]`` initial state) get a leading particle axis, which
        is the law of the JAX package's per-particle fallback draws."""
        bs = tuple(self.batch_shape())
        if len(bs) >= 1 and bs[0] == b:
            return bs
        return (b,) + bs

    def _draw(self, gen: torch.Generator, shape):
        """Draws of batch shape ``shape`` (event dims appended)."""
        raise NotImplementedError

    def sample(self, gen: torch.Generator):
        """One draw with the broadcast parameter shape (no particle axis)."""
        return self._draw(gen, tuple(self.batch_shape()))

    def sample_batched(self, gen: torch.Generator, b: int):
        """Draw a leading particle axis of ``b`` values in one pass."""
        return self._draw(gen, self._draw_shape(b))

    def log_prob(self, value):
        """Elementwise log density, float32."""
        raise NotImplementedError

    def logpdf(self, value):
        return self.log_prob(value)


class Normal(Distribution):
    __slots__ = ("loc", "scale")

    def __init__(self, loc: Any, scale: Any):
        self.loc = loc
        self.scale = scale

    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def _draw(self, gen, shape):
        dev = gen.device
        loc, scale = _f(self.loc, dev), _f(self.scale, dev)
        eps = torch.randn(shape, generator=gen, device=dev,
                          dtype=torch.float32)
        return loc + scale * eps

    def log_prob(self, value):
        dev = _device_of(value, self.loc, self.scale)
        loc, scale = _f(self.loc, dev), _f(self.scale, dev)
        z = (_f(value, dev) - loc) / scale
        half_log_2pi = 0.5 * torch.log(_f(2.0 * math.pi, dev))
        return -0.5 * z * z - torch.log(scale) - half_log_2pi


class Bernoulli(Distribution):
    __slots__ = ("p",)

    def __init__(self, p: Any):
        self.p = p

    def batch_shape(self):
        return _shape(self.p)

    def _draw(self, gen, shape):
        dev = gen.device
        p = _f(self.p, dev)
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return u < p

    def log_prob(self, value):
        dev = _device_of(value, self.p)
        p = torch.clamp(_f(self.p, dev), 1e-37, 1.0 - 1e-7)
        vb = torch.as_tensor(value, device=dev).to(torch.bool)
        return torch.where(vb, torch.log(p), torch.log1p(-p))


class UniformDiscrete(Distribution):
    """Uniform over the integers ``lo..hi`` inclusive (Gen's
    ``uniform_discrete``); values are int32."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: Any, hi: Any):
        self.lo = lo
        self.hi = hi

    def batch_shape(self):
        return _bshape(self.lo, self.hi)

    def _draw(self, gen, shape):
        dev = gen.device
        lo, hi = _i(self.lo, dev), _i(self.hi, dev)
        # floor(u * n) of a float64 uniform: exact to 2^-53 of the law,
        # with the clamp guarding the u * n rounding up to n
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
        k = torch.floor(u * (hi - lo + 1).to(torch.float64)).to(torch.int32)
        return lo + torch.minimum(k, hi - lo)

    def log_prob(self, value):
        dev = _device_of(value, self.lo, self.hi)
        lo, hi = _i(self.lo, dev), _i(self.hi, dev)
        v = _i(value, dev)
        n = (hi - lo + 1).to(torch.float32)
        return torch.where((v >= lo) & (v <= hi), -torch.log(n),
                           torch.full((), -math.inf, dtype=torch.float32,
                                      device=dev))


class Factor(Distribution):
    """A soft factor: contributes ``logw`` to the score whatever its
    (dummy, always-0) value. An unconstrained factor site cancels out of
    ``generate`` and fresh-``update`` weights, so a ``factor(beta *
    loglik)`` site turns an args-update into the tempered-SMC incremental
    weight Δbeta·loglik."""

    __slots__ = ("logw",)

    def __init__(self, logw: Any):
        self.logw = logw

    def batch_shape(self):
        return _shape(self.logw)

    def _draw(self, gen, shape):
        return torch.zeros(shape, dtype=torch.float32, device=gen.device)

    def log_prob(self, value):
        return _f(self.logw, _device_of(value, self.logw))




def _rand(gen, shape, dtype=torch.float32):
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _gamma1(gen, a, shape):
    """Standard gamma draws of shape ``shape`` with shape parameter
    ``a`` (float32, broadcast)."""
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=gen)


class Uniform(Distribution):
    """Uniform on ``[lo, hi]``."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: Any, hi: Any):
        self.lo = lo
        self.hi = hi

    def batch_shape(self):
        return _bshape(self.lo, self.hi)

    def _draw(self, gen, shape):
        lo, hi = _f(self.lo, gen.device), _f(self.hi, gen.device)
        return lo + (hi - lo) * _rand(gen, shape)

    def log_prob(self, value):
        dev = _device_of(value, self.lo, self.hi)
        lo, hi, v = _f(self.lo, dev), _f(self.hi, dev), _f(value, dev)
        return torch.where((v >= lo) & (v <= hi), -torch.log(hi - lo),
                           _neg_inf(dev))


def _gumbel_argmax(gen, logits, shape):
    """Categorical draws of batch shape ``shape`` by the Gumbel-max trick
    (``logits`` last axis: the categories)."""
    k = logits.shape[-1]
    u = _rand(gen, tuple(shape) + (k,))
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def _pick_last(x, idx):
    """``x[..., idx]`` along the last axis, broadcasting ``x``'s batch
    dims against ``idx``."""
    shape = torch.broadcast_shapes(tuple(x.shape[:-1]), tuple(idx.shape))
    xb = x.expand(shape + (x.shape[-1],))
    return torch.take_along_dim(xb, idx.expand(shape).long()[..., None],
                                dim=-1)[..., 0]


class Categorical(Distribution):
    """Categorical over ``0..K-1`` from unnormalized ``logits`` (last
    axis); values are int32."""

    __slots__ = ("logits",)

    def __init__(self, logits: Any):
        self.logits = logits

    def batch_shape(self):
        return _shape(self.logits)[:-1]

    def _draw(self, gen, shape):
        return _gumbel_argmax(gen, _f(self.logits, gen.device), shape)

    def log_prob(self, value):
        dev = _device_of(value, self.logits)
        logits = _f(self.logits, dev)
        k = logits.shape[-1]
        v = _i(value, dev)
        picked = _pick_last(logits, v.clamp(0, k - 1))
        logz = torch.logsumexp(logits, dim=-1)
        return torch.where((v >= 0) & (v < k), picked - logz, _neg_inf(dev))


class LabeledCategorical(Distribution):
    """Categorical over the ``labels`` (last axis) with ``probs``."""

    __slots__ = ("labels", "probs")

    def __init__(self, labels: Any, probs: Any):
        self.labels = labels
        self.probs = probs

    def batch_shape(self):
        return _shape(self.probs)[:-1]

    def _labels(self, dev):
        return torch.as_tensor(self.labels, device=dev)

    def _draw(self, gen, shape):
        idx = _gumbel_argmax(gen, torch.log(_f(self.probs, gen.device)),
                             shape)
        return _pick_last(self._labels(gen.device), idx)

    def log_prob(self, value):
        dev = _device_of(value, self.labels, self.probs)
        labels = self._labels(dev)
        match = torch.as_tensor(value, device=dev)[..., None] == labels
        p = torch.sum(torch.where(match, _f(self.probs, dev), _zero(dev)),
                      dim=-1)
        return torch.where(p > 0, torch.log(torch.clamp(p, min=1e-37)),
                           _neg_inf(dev))


class Poisson(Distribution):
    """Poisson counts (int32)."""

    __slots__ = ("rate",)

    def __init__(self, rate: Any):
        self.rate = rate

    def batch_shape(self):
        return _shape(self.rate)

    def _draw(self, gen, shape):
        rate = _f(self.rate, gen.device).expand(shape).contiguous()
        return torch.poisson(rate, generator=gen).to(torch.int32)

    def log_prob(self, value):
        dev = _device_of(value, self.rate)
        rate, v = _f(self.rate, dev), _f(value, dev)
        # 0*log(0) at (v=0, rate=0): P(0)=1 there
        vlog = torch.where(v > 0, v * torch.log(torch.clamp(rate, min=1e-37)),
                           _zero(dev))
        lp = vlog - rate - torch.lgamma(v + 1.0)
        return torch.where(v >= 0, lp, _neg_inf(dev))


class Gamma(Distribution):
    """Gamma with shape ``shape_`` (alpha) and ``scale``."""

    __slots__ = ("shape_", "scale")

    def __init__(self, shape_: Any, scale: Any):
        self.shape_ = shape_
        self.scale = scale

    def batch_shape(self):
        return _bshape(self.shape_, self.scale)

    def _draw(self, gen, shape):
        a, s = _f(self.shape_, gen.device), _f(self.scale, gen.device)
        return _gamma1(gen, a, shape) * s

    def log_prob(self, value):
        dev = _device_of(value, self.shape_, self.scale)
        a, s, v = _f(self.shape_, dev), _f(self.scale, dev), _f(value, dev)
        lp = ((a - 1.0) * torch.log(v) - v / s - torch.lgamma(a)
              - a * torch.log(s))
        return torch.where(v > 0, lp, _neg_inf(dev))


class Beta(Distribution):
    """Beta(a, b), drawn as G_a / (G_a + G_b) from two gamma draws."""

    __slots__ = ("a", "b")

    def __init__(self, a: Any, b: Any):
        self.a = a
        self.b = b

    def batch_shape(self):
        return _bshape(self.a, self.b)

    def _draw(self, gen, shape):
        x = _gamma1(gen, _f(self.a, gen.device), shape)
        y = _gamma1(gen, _f(self.b, gen.device), shape)
        return x / (x + y)

    def log_prob(self, value):
        dev = _device_of(value, self.a, self.b)
        a, b, v = _f(self.a, dev), _f(self.b, dev), _f(value, dev)
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        lp = (a - 1.0) * torch.log(v) + (b - 1.0) * torch.log1p(-v) - betaln
        return torch.where((v > 0) & (v < 1), lp, _neg_inf(dev))


class Exponential(Distribution):
    __slots__ = ("rate",)

    def __init__(self, rate: Any):
        self.rate = rate

    def batch_shape(self):
        return _shape(self.rate)

    def _draw(self, gen, shape):
        return -torch.log1p(-_rand(gen, shape)) / _f(self.rate, gen.device)

    def log_prob(self, value):
        dev = _device_of(value, self.rate)
        r, v = _f(self.rate, dev), _f(value, dev)
        return torch.where(v >= 0, torch.log(r) - r * v, _neg_inf(dev))


class Geometric(Distribution):
    """Number of failures before the first success, support 0, 1, 2, ...
    (int32)."""

    __slots__ = ("p",)

    def __init__(self, p: Any):
        self.p = p

    def batch_shape(self):
        return _shape(self.p)

    def _draw(self, gen, shape):
        p = _f(self.p, gen.device)
        u = _rand(gen, shape)
        return torch.floor(torch.log1p(-u) / torch.log1p(-p)).to(torch.int32)

    def log_prob(self, value):
        dev = _device_of(value, self.p)
        p = torch.clamp(_f(self.p, dev), 1e-37, 1.0)
        v = _f(value, dev)
        # 0*(-inf) at (v=0, p=1): P(0)=1 there
        vterm = torch.where(
            v > 0, v * torch.log1p(-torch.clamp(p, max=1 - 1e-7)),
            _zero(dev))
        return torch.where(v >= 0, vterm + torch.log(p), _neg_inf(dev))


class LogNormal(Distribution):
    __slots__ = ("loc", "scale")

    def __init__(self, loc: Any, scale: Any):
        self.loc = loc
        self.scale = scale

    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def _draw(self, gen, shape):
        return torch.exp(Normal(self.loc, self.scale)._draw(gen, shape))

    def log_prob(self, value):
        dev = _device_of(value, self.loc, self.scale)
        v = _f(value, dev)
        lv = torch.log(torch.clamp(v, min=1e-37))
        lp = Normal(self.loc, self.scale).log_prob(lv) - lv
        return torch.where(v > 0, lp, _neg_inf(dev))


class Laplace(Distribution):
    __slots__ = ("loc", "scale")

    def __init__(self, loc: Any, scale: Any):
        self.loc = loc
        self.scale = scale

    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def _draw(self, gen, shape):
        loc, scale = _f(self.loc, gen.device), _f(self.scale, gen.device)
        v = _rand(gen, shape) - 0.5
        a = torch.clamp(2.0 * v.abs(), max=1.0 - 2.0 ** -24)
        return loc - scale * torch.sign(v) * torch.log1p(-a)

    def log_prob(self, value):
        dev = _device_of(value, self.loc, self.scale)
        loc, scale = _f(self.loc, dev), _f(self.scale, dev)
        return -torch.abs(_f(value, dev) - loc) / scale - torch.log(
            2.0 * scale)


class Cauchy(Distribution):
    __slots__ = ("loc", "scale")

    def __init__(self, loc: Any, scale: Any):
        self.loc = loc
        self.scale = scale

    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def _draw(self, gen, shape):
        loc, scale = _f(self.loc, gen.device), _f(self.scale, gen.device)
        return loc + scale * torch.tan(math.pi * (_rand(gen, shape) - 0.5))

    def log_prob(self, value):
        dev = _device_of(value, self.loc, self.scale)
        loc, scale = _f(self.loc, dev), _f(self.scale, dev)
        z = (_f(value, dev) - loc) / scale
        return -torch.log(math.pi * scale * (1.0 + z * z))


class StudentT(Distribution):
    """Student's t with ``df`` degrees of freedom, ``loc`` and ``scale``:
    a normal over the square root of a chi-square (a gamma draw) per
    degree of freedom."""

    __slots__ = ("df", "loc", "scale")

    def __init__(self, df: Any, loc: Any, scale: Any):
        self.df = df
        self.loc = loc
        self.scale = scale

    def batch_shape(self):
        return _bshape(self.df, self.loc, self.scale)

    def _draw(self, gen, shape):
        dev = gen.device
        df = _f(self.df, dev)
        z = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        g = _gamma1(gen, 0.5 * df, shape)
        t = z * torch.sqrt(0.5 * df / g)
        return _f(self.loc, dev) + _f(self.scale, dev) * t

    def log_prob(self, value):
        dev = _device_of(value, self.df, self.loc, self.scale)
        df, loc = _f(self.df, dev), _f(self.loc, dev)
        scale = _f(self.scale, dev)
        z = (_f(value, dev) - loc) / scale
        return (torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                - ((df + 1.0) / 2.0) * torch.log1p(z * z / df))


class MvNormalDiag(Distribution):
    """Multivariate normal with a diagonal covariance; the event is the
    last axis."""

    __slots__ = ("loc", "scale_diag")
    event_ndim = 1

    def __init__(self, loc: Any, scale_diag: Any):
        self.loc = loc
        self.scale_diag = scale_diag

    def _full(self):
        return _bshape(self.loc, self.scale_diag)

    def batch_shape(self):
        return self._full()[:-1]

    def _draw(self, gen, shape):
        d = self._full()[-1]
        loc, sd = _f(self.loc, gen.device), _f(self.scale_diag, gen.device)
        eps = torch.randn(tuple(shape) + (d,), generator=gen,
                          device=gen.device, dtype=torch.float32)
        return loc + sd * eps

    def log_prob(self, value):
        return torch.sum(Normal(self.loc, self.scale_diag).log_prob(value),
                         dim=-1)


class MvNormal(Distribution):
    """Multivariate normal with a full covariance ``cov``; the event is the
    last axis. The Cholesky factor is taken without an error check (which
    would read the device): a ``cov`` that is not positive definite gives
    NaN scores."""

    __slots__ = ("loc", "cov")
    event_ndim = 1

    def __init__(self, loc: Any, cov: Any):
        self.loc = loc
        self.cov = cov

    def batch_shape(self):
        return _shape(self.loc)[:-1]

    def _chol(self, dev):
        return torch.linalg.cholesky_ex(_f(self.cov, dev)).L

    def _draw(self, gen, shape):
        loc = _f(self.loc, gen.device)
        L = self._chol(gen.device)
        eps = torch.randn(tuple(shape) + (loc.shape[-1],), generator=gen,
                          device=gen.device, dtype=torch.float32)
        return loc + torch.matmul(L, eps[..., None])[..., 0]

    def log_prob(self, value):
        dev = _device_of(value, self.loc, self.cov)
        loc = _f(self.loc, dev)
        L = self._chol(dev)
        d = loc.shape[-1]
        diff = _f(value, dev) - loc
        z = torch.linalg.solve_triangular(L, diff[..., None], upper=False)
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)
        return (-0.5 * torch.sum(z[..., 0] ** 2, dim=-1) - logdet
                - 0.5 * d * math.log(2.0 * math.pi))


class Delta(Distribution):
    """A point mass at ``value`` (for deterministic, transformed sites)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def batch_shape(self):
        return _shape(self.value)

    def _at(self, dev):
        v = self.value
        if isinstance(v, bool):
            return torch.full((), v, dtype=torch.bool, device=dev)
        if isinstance(v, int):
            return _i(v, dev)
        if isinstance(v, float):
            return _f(v, dev)
        return torch.as_tensor(v, device=dev)

    def _draw(self, gen, shape):
        return self._at(gen.device).expand(shape).clone()

    def log_prob(self, value):
        dev = _device_of(value, self.value)
        eq = torch.as_tensor(value, device=dev) == self._at(dev)
        return torch.where(eq, _zero(dev), _neg_inf(dev))

normal = Normal
bernoulli = Bernoulli
uniform_discrete = UniformDiscrete
factor = Factor
uniform = Uniform
categorical = Categorical
labeled_categorical = LabeledCategorical
poisson = Poisson
gamma = Gamma
beta = Beta
exponential = Exponential
geometric = Geometric
lognormal = LogNormal
laplace = Laplace
cauchy = Cauchy
student_t = StudentT
mvnormal_diag = MvNormalDiag
mvnormal = MvNormal
delta = Delta
