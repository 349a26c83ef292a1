"""G4, the merge count (genparticlefilters_tpu_torch/ops/merge_count.py),
against the JAX package: F_i = #{j : u_j <= c_i} must be bit-equal to
(a) JAX's _merge_count(c, u) on the CPU, (b) the F read off the sorted
keys of JAX's bitonic_merge_sorted(z, interpret=True), with z built as
_merge_count builds it, and (c) np.searchsorted(u, c, side="right"). The
CUDA kernel itself is checked against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from genparticlefilters_tpu.ops.merge_count import (  # noqa: E402
    bitonic_merge_sorted)
from genparticlefilters_tpu.smc.resample import _merge_count  # noqa: E402
from genparticlefilters_tpu_torch.ops.merge_count import (  # noqa: E402
    merge_count, merge_count_plain)


def _F_from_bitonic(c, u):
    """_merge_count's key packing and F extraction around the Pallas merge
    kernel (interpret mode)."""
    n, m = len(c), len(u)
    Mp = 1 << max(1, (n + m - 1).bit_length())
    ck = (c.view(np.int32) << 1) | 1
    uk = u.view(np.int32) << 1
    pad = np.iinfo(np.int32).max - 1
    z = np.concatenate([ck, np.full(Mp - n - m, pad, np.int32), uk[::-1]])
    z = np.asarray(bitonic_merge_sorted(jnp.asarray(z), interpret=True))
    tags = z & 1
    r = np.cumsum(tags) - tags          # rank among the c keys
    F = np.zeros(n, np.int32)
    F[r[tags == 1]] = (np.arange(Mp) - r)[tags == 1]
    return F


def _inputs(rng, n, m, kind):
    w = rng.dirichlet(np.full(n, 0.5))
    w[3:7] = 0.0                         # zero-weight run: duplicate c
    c = np.cumsum(w).astype(np.float32)
    c = (c / c[-1]).astype(np.float32)
    u = np.sort(rng.random(m).astype(np.float32))
    if kind == "ties":
        # exact ties u_j == c_i, which count (side='right')
        pick = rng.choice(n, size=min(n, m) // 4, replace=False)
        u[:len(pick)] = c[pick]
        u = np.sort(u)
    elif kind == "padded":
        # residual's padding: the first R real draws, the rest 1.75, with
        # a few real draws capped at 1.5
        r = m // 2
        u[r:] = np.float32(1.75)
        u[r - 3:r] = np.float32(1.5)
    return c, u


CASES = [(n, m, kind) for n, m in [(1000, 1000), (1500, 600), (700, 2100),
                                   (2048, 2048)]
         for kind in ("plain", "ties", "padded")]


@pytest.mark.parametrize("n,m,kind", CASES)
def test_merge_count_matches_jax(n, m, kind):
    rng = np.random.default_rng(7 * n + m + len(kind))
    c, u = _inputs(rng, n, m, kind)
    want = np.searchsorted(u, c, side="right").astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(_merge_count(jnp.asarray(c), jnp.asarray(u))), want)
    if n + m <= 4096:
        np.testing.assert_array_equal(_F_from_bitonic(c, u), want)
    tc, tu = torch.from_numpy(c), torch.from_numpy(u)
    for fn in (merge_count, merge_count_plain):
        F = fn(tc, tu)
        assert F.dtype == torch.int32 and F.shape == (n,)
        np.testing.assert_array_equal(F.numpy(), want)


def test_merge_count_wrapper_validates_inputs():
    c = torch.tensor([0.1, 0.5, 0.5, 1.0])
    u = torch.tensor([0.1, 0.2, 0.5, 1.5, 1.75])
    with pytest.raises(ValueError):
        merge_count(c.double(), u)
    with pytest.raises(ValueError):
        merge_count(c, u[::2])           # not contiguous
    with pytest.raises(ValueError):
        merge_count(c.reshape(2, 2), u)
    before = merge_count.launches
    assert merge_count(c, u).tolist() == [1, 3, 3, 3]
    assert merge_count.launches == before   # CPU: the plain version
