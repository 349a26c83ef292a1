"""Primitive distributions: ``logpdf`` and batched sampling on tensors.

Parameters may be Python numbers or float32 tensors (a per-particle ``[N]``
tensor, or a shared 0-d one). Everything runs in float32, as the JAX
package does with x64 off: a Python constant enters as a float32 tensor on
the device of the value it meets.
"""

from __future__ import annotations

import math
from typing import Any

import torch

__all__ = ["Distribution", "Normal", "normal", "Bernoulli", "bernoulli",
           "UniformDiscrete", "uniform_discrete", "Factor", "factor"]


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
    axis of size ``batch`` from one generator; ``log_prob`` is elementwise."""

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
        return torch.broadcast_shapes(tuple(torch.as_tensor(self.loc).shape),
                                      tuple(torch.as_tensor(self.scale).shape))

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
        return tuple(torch.as_tensor(self.p).shape)

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
        return torch.broadcast_shapes(tuple(torch.as_tensor(self.lo).shape),
                                      tuple(torch.as_tensor(self.hi).shape))

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
        return tuple(torch.as_tensor(self.logw).shape)

    def _draw(self, gen, shape):
        return torch.zeros(shape, dtype=torch.float32, device=gen.device)

    def log_prob(self, value):
        return _f(self.logw, _device_of(value, self.logw))


normal = Normal
bernoulli = Bernoulli
uniform_discrete = UniformDiscrete
factor = Factor
