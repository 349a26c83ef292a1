"""Systematic resampling (genparticlefilters_tpu_torch/smc/resample.py)
against the JAX package.

Given the same hit counts F, everything downstream is integer or exact
float32 work: parents, gathered pieces, post-resample weights and the LML
fold must agree bit for bit (the LML and the custom-priority weights pass
through a logsumexp, whose summation order differs: atol 1e-5).

Given the same weights and the same shared uniform u0, F itself comes from
a float32 cumsum whose association differs between the two frameworks, so
F may differ by one count where n·cumsum(w) − u0 lies within float32
resolution of an integer. The tolerance is set from the dtype: a tie is
an index whose float64 value lies within 2 ulps of float32 at magnitude n
(2·ulp32(100001) = 0.0156) of an integer; every mismatch must be a tie,
and mismatches stay under 0.5% of n (0.2% measured at n=100001)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from genparticlefilters_tpu.smc import resample as jres  # noqa: E402
from genparticlefilters_tpu_torch.smc import resample as tres  # noqa: E402

SIZES = [600, 1000, 4096, 100001]


def _weights(n, seed):
    return np.random.default_rng(seed).dirichlet(
        np.full(n, 0.4)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_given_F_parents_gather_weights_lml_match(n):
    rng = np.random.default_rng(n)
    w = _weights(n, n)
    F = np.array(jres.systematic_F(jr.key(n), jnp.asarray(w)))
    tF = torch.from_numpy(F)

    ref_par = np.array(jres._F_to_parents(jnp.asarray(F), n))
    np.testing.assert_array_equal(tres._F_to_parents(tF, n).numpy(), ref_par)
    counts = np.diff(F, prepend=0).astype(np.int32)
    np.testing.assert_array_equal(
        tres.counts_to_parents(torch.from_numpy(counts), n).numpy(),
        np.asarray(jres.counts_to_parents(jnp.asarray(counts), n)))

    pieces = [rng.integers(-2**31, 2**31 - 1, size=(wd, n), dtype=np.int32)
              for wd in (1, 1, 1, 40)]
    outs, parents = tres.resample_gather_split(
        [torch.from_numpy(p) for p in pieces], tF)
    np.testing.assert_array_equal(parents.numpy(), ref_par)
    for o, p in zip(outs, pieces):
        np.testing.assert_array_equal(
            o.numpy(), np.asarray(jnp.take(jnp.asarray(p),
                                           jnp.asarray(ref_par), axis=1)))

    lw = rng.normal(0.0, 3.0, size=n).astype(np.float32)
    lp = (0.5 * lw).astype(np.float32)
    tpar = torch.from_numpy(ref_par)
    for custom in (False, True):
        ref = np.asarray(jres._new_weights_full(
            n, jnp.asarray(lw), jnp.asarray(lp), jnp.asarray(ref_par),
            custom))
        got = tres._new_weights_full(n, torch.from_numpy(lw),
                                     torch.from_numpy(lp), tpar,
                                     custom).numpy()
        if custom:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got, ref)

    # the LML fold of a full-state resample
    from genparticlefilters_tpu.utils.weights import logsumexp as jlse
    lml0 = np.float32(-3.25)
    ref_lml = float(lml0 + jlse(jnp.asarray(lw)) - jnp.log(float(n)))
    from genparticlefilters_tpu_torch.utils.weights import (logsumexp,
                                                            log_float32)
    got_lml = float(torch.tensor(lml0) + logsumexp(torch.from_numpy(lw))
                    - log_float32(n, "cpu"))
    assert abs(got_lml - ref_lml) <= 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_systematic_F_same_u0_differs_only_at_ties(n):
    w = _weights(n, n + 1)
    key = jr.key(n + 2)
    ref = np.asarray(jres.systematic_F(key, jnp.asarray(w)))
    u0 = np.float32(jr.uniform(key, (), dtype=jnp.float32))
    got = tres.systematic_F(None, torch.from_numpy(w), u0=u0).numpy()
    assert got.dtype == np.int32 and got[-1] == n
    assert np.all(np.diff(got) >= 0)
    x = n * np.cumsum(w.astype(np.float64)) - np.float64(u0)
    dist = np.abs(x - np.round(x))
    tie = dist <= 2 * np.spacing(np.float32(n))
    bad = np.nonzero(got != ref)[0]
    assert np.all(tie[bad]), (bad[~tie[bad]], dist[bad])
    assert np.all(np.abs(got[bad].astype(np.int64) - ref[bad]) <= 1)
    assert len(bad) <= 0.005 * n, len(bad)


def test_F_monotone_on_degenerate_weights():
    # 2^18+13 particles, nearly all mass on one: the case where a
    # reassociating scan broke monotonicity on the TPU; the cummax guard
    # keeps F (and so the parents) monotone whatever the scan does
    n = 2**18 + 13
    w = np.full(n, 1e-12, np.float64)
    w[n // 3] = 1.0
    w = (w / w.sum()).astype(np.float32)
    F = tres.systematic_F(torch.Generator().manual_seed(0),
                          torch.from_numpy(w))
    assert F[-1].item() == n and bool(torch.all(F[1:] >= F[:-1]))
    parents = tres._F_to_parents(F, n)
    assert bool(torch.all(parents[1:] >= parents[:-1]))
    assert parents.min().item() >= 0 and parents.max().item() < n
    # a hit-count vector with a one-count dip (what a reassociated float32
    # scan can produce) comes out monotone and pinned
    dip = torch.tensor([1, 3, 2, 5, 6, 6], dtype=torch.int32)
    assert tres._pinned_F(dip, 6).tolist() == [1, 3, 3, 5, 6, 6]


def test_pf_resample_dispatch():
    assert set(tres._METHODS) == {"multinomial", "residual", "stratified",
                                  "systematic"}
    assert tres._METHODS["residual"] is tres.pf_residual_resample
    with pytest.raises(ValueError):
        tres.pf_resample(None, None, "nonsense")
