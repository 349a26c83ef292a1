"""G4, the merge count (genparticlefilters_tpu_torch/ops/merge_count.py),
against the JAX package: F_i = #{j : u_j <= c_i} must be bit-equal to
(a) JAX's _merge_count(c, u) on the CPU, (b) the F read off the sorted
keys of JAX's bitonic_merge_sorted(z, interpret=True), with z built as
_merge_count builds it, and (c) np.searchsorted(u, c, side="right"). The
CUDA kernel itself is checked against the plain version on the card by
chip_smoke.py; its merge-path partition is modelled here in numpy
(_merge_path_count) and held against np.searchsorted on the same inputs."""

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
    Mp = max(128, 1 << max(1, (n + m - 1).bit_length()))  # the kernel's
    #                                                         smallest M
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


def _skewed(rng, n, m, kind):
    """The skewed inputs: all the mass on one particle (``first``, c all
    1.0) or on the last (c zero but for the last), all-equal u (equal to a
    c value, so every u ties), or a plain dirichlet c against uniform u."""
    if kind == "mass_first":
        c = np.ones(n, np.float32)
    elif kind == "mass_last":
        c = np.zeros(n, np.float32)
        c[-1] = 1.0
    else:
        c, _ = _inputs(rng, n, max(m, 1), "plain")
    u = np.sort(rng.random(m).astype(np.float32))
    if kind == "equal_u":
        u = np.full(m, c[n // 2], np.float32)
    return c, u


SKEWED = [(1000, 1000, "mass_first"), (1000, 1000, "mass_last"),
          (1000, 1000, "equal_u"), (1000, 1, "plain"), (1, 1000, "plain"),
          (1, 1, "plain"), (600, 2400, "plain"), (2400, 600, "plain"),
          (2000, 0, "plain"), (50_000, 200_000, "plain"),
          (200_000, 50_000, "mass_last")]


@pytest.mark.parametrize("n,m,kind", SKEWED)
def test_merge_count_skewed_matches_jax(n, m, kind):
    # degenerate weights, all-equal u, n or m = 1, m >> n and n >> m, m = 0
    rng = np.random.default_rng(3 * n + m + len(kind))
    c, u = _skewed(rng, n, m, kind)
    want = np.searchsorted(u, c, side="right").astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(_merge_count(jnp.asarray(c), jnp.asarray(u))), want)
    if n + m <= 4096:
        np.testing.assert_array_equal(_F_from_bitonic(c, u), want)
    for fn in (merge_count, merge_count_plain):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(c), torch.from_numpy(u)).numpy(), want)


PROBES = 32   # the kernel's lanes x probes per lane (G4_PROBES)


def _split(c, u, d, rounds=None):
    """The kernel's diagonal split (split_warp): the largest i in
    [max(0, d - m), min(d, n)] with i == 0, d - i >= m or c[i-1] < u[d-i],
    by the 32-ary search; the probes that hold must form a prefix."""
    n, m = len(c), len(u)
    lo, hi = max(0, d - m), min(d, n)
    while hi > lo:
        step = -(-(hi - lo) // PROBES)
        p = lo + np.arange(1, PROBES + 1) * step
        ok = p <= hi
        pc = np.minimum(p, hi)
        j = d - pc
        q = ok & ((j >= m) | (c[pc - 1] < u[np.minimum(j, m - 1)]))
        k = int(q.sum())
        assert q[:k].all() and not q[k:].any()
        lo += k * step
        hi = min(hi, lo + step - 1)
        if rounds is not None:
            rounds.append(k)
    return lo


def _merge_path_count(c, u, tile, items):
    """The kernel's arithmetic in numpy: tiles of ``tile`` merged elements
    cut at diagonal splits, each thread's ``items`` positions split inside
    the tile the same way, then merged serially with the tie rule (u_j
    before c_i iff u_j <= c_i): F_i = j0 + the u taken before c_i."""
    n, m = len(c), len(u)
    F = np.full(n, -1, np.int64)
    for d0 in range(0, n + m, tile):
        d1 = min(d0 + tile, n + m)
        i0, i1 = _split(c, u, d0), _split(c, u, d1)
        j0 = d0 - i0
        # the tile's c lifted to its running maximum, seeded with the c
        # before the tile (the kernel's lift_dips; identity on sorted c)
        tc = np.maximum.accumulate(np.concatenate(
            [c[max(i0 - 1, 0):i0], c[i0:i1]]))[min(i0, 1):]
        tu = u[j0:d1 - i1]
        for dd in range(0, d1 - d0, items):
            ii = _split(tc, tu, dd)
            jj = dd - ii
            for _ in range(min(items, d1 - d0 - dd)):
                if jj < len(tu) and (ii >= len(tc) or tu[jj] <= tc[ii]):
                    jj += 1
                else:
                    F[i0 + ii] = j0 + jj
                    ii += 1
    return F


@pytest.mark.parametrize("n,m,kind", SKEWED[:9] + [(3000, 3000, "ties"),
                                                    (3000, 3000, "padded")])
def test_merge_path_model_matches_searchsorted(n, m, kind):
    rng = np.random.default_rng(5 * n + m + len(kind))
    if kind in ("ties", "padded"):
        c, u = _inputs(rng, n, m, kind)
    else:
        c, u = _skewed(rng, n, m, kind)
    want = np.searchsorted(u, c, side="right")
    for tile, items in ((64, 8), (2048, 8), (4096, 16)):
        np.testing.assert_array_equal(_merge_path_count(c, u, tile, items),
                                      want)


def test_merge_path_model_lifts_cumsum_dips():
    # a float32 cumsum on the card dips by an ulp where its scan blocks
    # meet; the kernel counts for the running maximum of c, which is what
    # _pinned_F's cummax makes of the plain per-element count
    rng = np.random.default_rng(12)
    n = m = 3000
    c = np.cumsum(rng.dirichlet(np.full(n, 0.5))).astype(np.float32)
    c /= c[-1]
    at = rng.choice(np.arange(1, n - 1), size=40, replace=False)
    c[at] = np.nextafter(c[at - 1], np.float32(0))      # one-ulp dips
    u = np.sort(rng.random(m).astype(np.float32))
    u[:40] = c[at]                                       # ties at the dips
    u = np.sort(u)
    plain = np.searchsorted(u, c, side="right")
    want = np.maximum.accumulate(plain)
    np.testing.assert_array_equal(
        want, np.searchsorted(u, np.maximum.accumulate(c), side="right"))
    for tile, items in ((64, 8), (2048, 8)):
        np.testing.assert_array_equal(_merge_path_count(c, u, tile, items),
                                      want)


def test_merge_path_split_tie_rule_and_rounds():
    # a u equal to a c lands on the u side: c = u = [0.5] merges as u, c,
    # so diagonal 1 holds no c and F = 1
    c = u = np.array([0.5], np.float32)
    assert _split(c, u, 1) == 0 and _split(c, u, 2) == 1
    assert _merge_path_count(c, u, 2, 1).tolist() == [1]
    # the split is the number of c among the first d merged elements, found
    # in at most 4 rounds for n = m = 1M (32x narrower per round)
    rng = np.random.default_rng(9)
    n = m = 1 << 20
    c = np.sort(rng.random(n).astype(np.float32))
    u = np.sort(rng.random(m).astype(np.float32))
    pos = np.arange(n) + np.searchsorted(u, c, side="right")
    for d in (0, 1, 777_777, n, n + m - 5, n + m):
        rounds = []
        assert _split(c, u, d, rounds) == int((pos < d).sum())
        assert len(rounds) <= 4
