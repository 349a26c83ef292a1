"""TPU rows 8 and 9 (``_resample_gather_packed`` and
``resample_gather_transposed``), the JAX package's route for packs wider
than its lane kernels' 1022-row cap, are covered by G1 and G2: their
contract is parents from hit counts F (``p_j = #{i : F_i <= j}``) plus an
exact int32 gather, which is G1's, and G2's through the merge count. G1
and G2 read ``[w, N]`` pieces in place at any width, so the port's route
for a wide pack is the same kernel with no transpose. Here the plain
versions of G1 and G2 (what CPU tensors run, and what the card holds the
kernels to) are held bit-equal to both TPU kernels in interpret mode."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

from genparticlefilters_tpu.ops import fused_gather as jfg  # noqa: E402
from genparticlefilters_tpu.smc import resample as jres  # noqa: E402
from genparticlefilters_tpu_torch.ops.fused_gather import (  # noqa: E402
    resample_gather_split_plain, resample_gather_split_u_plain)


def _ints(rng, shape):
    return rng.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(
        np.int32)


def _weights(n, seed):
    return np.random.default_rng(seed).dirichlet(
        np.full(n, 0.5)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


@pytest.mark.parametrize("n,d", [(1000, 43), (2048, 20),    # row 8, d1 <= 62
                                 (2048, 72), (512, 96)])    # row 9
def test_G1_matches_transposed_resample_kernels(n, d):
    rng = np.random.default_rng(n + d)
    mat = _ints(rng, (n, d))
    F = np.asarray(jres.systematic_F(jr.key(n + d),
                                     jnp.asarray(_weights(n, d))))
    ref_out, ref_par = jfg.resample_gather_transposed(
        jnp.asarray(mat), jnp.asarray(F), interpret=True)
    (out,), parents = resample_gather_split_plain([_t(mat.T)], _t(F))
    np.testing.assert_array_equal(parents.numpy(), np.asarray(ref_par))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


def test_G1_matches_the_wide_lane_route():
    # resample_gather_rows past the 1022-row cap reroutes to row 9
    n, d = 1024, 1025
    rng = np.random.default_rng(5)
    big = _ints(rng, (d, n))
    F = np.asarray(jres.systematic_F(jr.key(5), jnp.asarray(_weights(n, 5))))
    ref_out, ref_par = jfg.resample_gather_rows(jnp.asarray(big),
                                                jnp.asarray(F),
                                                interpret=True)
    (out,), parents = resample_gather_split_plain([_t(big)], _t(F))
    np.testing.assert_array_equal(parents.numpy(), np.asarray(ref_par))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))


@pytest.mark.parametrize("n,d", [(1000, 43), (2048, 72)])
def test_G2_matches_the_wide_multinomial_route(n, d):
    # the JAX package's multinomial gather of a wide pack: merge count,
    # pinned F, then the transposed resample kernel; G2 reads the same
    # (c, u) directly
    rng = np.random.default_rng(n * d)
    mat = _ints(rng, (n, d))
    c, u = jres.multinomial_cu(jr.key(d), jnp.asarray(_weights(n, n)))
    F = jres._pinned_F(jres._merge_count(c, u), n)
    ref_out, ref_par = jfg.resample_gather_transposed(
        jnp.asarray(mat), F, interpret=True)
    (out,), parents = resample_gather_split_u_plain(
        [_t(mat.T)], _t(np.asarray(c)), _t(np.asarray(u)))
    np.testing.assert_array_equal(parents.numpy(), np.asarray(ref_par))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
