"""G2, the float-bracket gather (genparticlefilters_tpu_torch/ops/
fused_gather.py: resample_gather_split_u), against the JAX package in
interpret mode: resample_gather_split_u at n >= 1024 and
resample_gather_rows_u (the same semantics over the concatenated pieces)
at n < 1024. Parents and gathered rows must be bit-equal, on the CPU route
of the wrapper and on its plain version: only float32 compares and int32
moves happen. The CUDA kernel itself is checked against the plain version
on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from genparticlefilters_tpu.ops.fused_gather import (  # noqa: E402
    resample_gather_rows_u as jax_rows_u,
    resample_gather_split_u as jax_split_u)
from genparticlefilters_tpu_torch.ops.fused_gather import (  # noqa: E402
    resample_gather_split_u, resample_gather_split_u_plain)


def _brackets(rng, n, m, kind):
    """(c [n], u [m]) float32: normalized cumulative weights with a run of
    zero-weight particles (duplicate edges), and sorted uniforms."""
    w = rng.dirichlet(np.full(n, 0.5))
    w[5:9] = 0.0
    c = np.cumsum(w).astype(np.float32)
    c = (c / c[-1]).astype(np.float32)
    u = np.sort(rng.random(m).astype(np.float32))
    if kind == "zero_u":
        u[0] = 0.0                      # clamped to 1e-37 by the kernel
    elif kind == "short_c":
        c = (c * np.float32(0.999)).astype(np.float32)
        u[-3:] = np.float32(0.9995)     # above c[-1]: the catch-all edge
        u = np.sort(u)
    return c, u


def _jax_ref(pieces, c, u):
    n = c.shape[0]
    if n >= 1024 and pieces:
        outs, par = jax_split_u([jnp.asarray(p) for p in pieces],
                                jnp.asarray(c), jnp.asarray(u),
                                interpret=True)
        return [np.asarray(o) for o in outs], np.asarray(par)
    big = (np.concatenate(pieces) if pieces
           else np.zeros((0, n), np.int32))
    out, par = jax_rows_u(jnp.asarray(big), jnp.asarray(c), jnp.asarray(u),
                          interpret=True)
    out = np.asarray(out)
    offs = np.cumsum([0] + [p.shape[0] for p in pieces])
    return [out[a:b] for a, b in zip(offs[:-1], offs[1:])], np.asarray(par)


CASES = ([(n, m, w, "plain") for n, m in [(2048, 2048), (1000, 1000),
                                          (513, 513), (2048, 1024),
                                          (1000, 2000)]
          for w in [(1, 1, 1, 40), (40, 1, 7)]]
         + [(2048, 2048, (1, 1, 1, 40), "zero_u"),
            (1000, 1000, (40, 1, 7), "zero_u"),
            (2048, 2048, (40, 1, 7), "short_c"),
            (513, 513, (1, 1, 1, 40), "short_c"),
            (2048, 2048, (), "plain"),
            (2048, 777, (), "plain")])


@pytest.mark.parametrize("n,m,widths,kind", CASES)
def test_gather_u_matches_jax_interpret(n, m, widths, kind):
    rng = np.random.default_rng(n + 3 * m + len(widths))
    pieces = [rng.integers(-2**31, 2**31 - 1, size=(w, n), dtype=np.int32)
              for w in widths]
    c, u = _brackets(rng, n, m, kind)
    ref_outs, ref_par = _jax_ref(pieces, c, u)
    np.testing.assert_array_equal(
        ref_par, np.searchsorted(c[:-1], np.maximum(u, np.float32(1e-37)),
                                 side="left"))
    tp = [torch.from_numpy(p) for p in pieces]
    for fn in (resample_gather_split_u, resample_gather_split_u_plain):
        outs, parents = fn(tp, torch.from_numpy(c), torch.from_numpy(u))
        assert parents.dtype == torch.int32 and parents.shape == (m,)
        np.testing.assert_array_equal(parents.numpy(), ref_par)
        assert len(outs) == len(widths)
        for o, r, w in zip(outs, ref_outs, widths):
            assert o.dtype == torch.int32 and o.shape == (w, m)
            np.testing.assert_array_equal(o.numpy(), r)


def test_gather_u_wrapper_validates_inputs():
    c = torch.tensor([0.25, 0.5, 0.5, 1.0])
    u = torch.tensor([0.0, 0.3, 0.6, 0.99])
    ok = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        resample_gather_split_u([ok], c.double(), u)
    with pytest.raises(ValueError):
        resample_gather_split_u([ok], c, u.to(torch.float16))
    with pytest.raises(ValueError):
        resample_gather_split_u([ok.float()], c, u)
    with pytest.raises(ValueError):
        resample_gather_split_u([torch.zeros((3, 5), dtype=torch.int32)], c,
                                u)
    with pytest.raises(ValueError):   # [3, 4] but not contiguous
        resample_gather_split_u(
            [torch.zeros((4, 3), dtype=torch.int32).t()], c, u)
    before = resample_gather_split_u.launches
    _, parents = resample_gather_split_u([ok], c, u)
    # u = 0 lands in bracket 0; 0.6 skips the empty bracket 2 (c[1] == c[2])
    assert parents.tolist() == [0, 1, 3, 3]
    # the CPU route runs the plain version: no kernel launch is counted
    assert resample_gather_split_u.launches == before
