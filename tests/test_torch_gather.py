"""G1 gather (genparticlefilters_tpu_torch/ops/fused_gather.py) against
the JAX package's resample_gather_split in interpret mode: outputs and
parents bit-equal, on the CPU route of the wrapper and on its plain
version. The CUDA kernel itself is checked against the plain version on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from genparticlefilters_tpu.ops.fused_gather import (  # noqa: E402
    resample_gather_split as jax_resample_gather_split)
from genparticlefilters_tpu_torch.ops.fused_gather import (  # noqa: E402
    resample_gather_split, resample_gather_split_plain)


def _hit_counts(w, m, u0):
    """Systematic pinned hit counts in float64 (any valid F will do: the
    gather's contract is on F, not on how F was drawn)."""
    c = m * np.cumsum(np.asarray(w, np.float64)) - u0
    F = np.clip(np.floor(c).astype(np.int64) + 1, 0, m)
    F[-1] = m
    return np.maximum.accumulate(F).astype(np.int32)


def _weights(rng, n, kind):
    if kind == "dirichlet":
        return rng.dirichlet(np.full(n, 0.4))
    if kind == "every8":
        # each 512-output block's parents span ~4096 source lanes: the TPU
        # slab kernel's overflow (residual chunk) path
        w = (np.arange(n) % 8 == 0).astype(np.float64)
        return w / w.sum()
    if kind == "degenerate":
        w = np.zeros(n)
        w[n - 1] = 1.0
        return w
    raise ValueError(kind)


CASES = [
    (2048, 2048, (40, 1, 7), "dirichlet"),
    (1000, 1000, (40, 1, 7), "dirichlet"),
    (2048, 1024, (40, 1, 7), "dirichlet"),
    (600, 1200, (40, 1, 7), "dirichlet"),
    (4096, 4096, (9, 1), "every8"),
    (900, 900, (5,), "degenerate"),
    (2048, 2048, (1, 1, 1, 40), "dirichlet"),
]


@pytest.mark.parametrize("n,m,widths,kind", CASES)
def test_gather_matches_jax_interpret(n, m, widths, kind):
    rng = np.random.default_rng(n + m + len(widths))
    pieces = [rng.integers(-2**31, 2**31 - 1, size=(w, n), dtype=np.int32)
              for w in widths]
    F = _hit_counts(_weights(rng, n, kind), m, rng.uniform())
    ref_outs, ref_par = jax_resample_gather_split(
        [jnp.asarray(p) for p in pieces], jnp.asarray(F), n_out=m,
        interpret=True)
    ref_par = np.asarray(ref_par)
    np.testing.assert_array_equal(
        ref_par, np.searchsorted(F, np.arange(m), side="right"))
    tp = [torch.from_numpy(p) for p in pieces]
    tF = torch.from_numpy(F)
    for fn in (resample_gather_split, resample_gather_split_plain):
        outs, parents = fn(tp, tF, n_out=m)
        assert parents.dtype == torch.int32 and parents.shape == (m,)
        np.testing.assert_array_equal(parents.numpy(), ref_par)
        assert len(outs) == len(widths)
        for o, r, w in zip(outs, ref_outs, widths):
            assert o.dtype == torch.int32 and o.shape == (w, m)
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_gather_wrapper_validates_inputs():
    F = torch.tensor([1, 2, 2, 4], dtype=torch.int32)
    ok = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        resample_gather_split([ok], F.to(torch.int64))
    with pytest.raises(ValueError):
        resample_gather_split([ok.to(torch.float32)], F)
    with pytest.raises(ValueError):
        resample_gather_split([torch.zeros((3, 5), dtype=torch.int32)], F)
    with pytest.raises(ValueError):  # [3, 4] but not contiguous
        resample_gather_split([torch.zeros((4, 3), dtype=torch.int32).t()],
                              F)
    before = resample_gather_split.launches
    outs, parents = resample_gather_split([ok], F)
    assert parents.tolist() == [0, 1, 3, 3]
    # the CPU route runs the plain version: no kernel launch is counted
    assert resample_gather_split.launches == before
