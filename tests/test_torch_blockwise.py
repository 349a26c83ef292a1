"""Blockwise resampling on one device (genparticlefilters_tpu_torch/
parallel/distributed.py and ``blockwise_compose``, ``_resample_block`` in
smc/resample.py) against the JAX package.

- Systematic composition is bit-identical to the per-block hit counts plus
  block offsets (as tests/test_ops.py pins for JAX).
- Multinomial, unsorted stratified and residual compositions are float32
  elementwise maps of the per-block brackets and draws: they equal numpy
  float32 evaluations of the JAX package's formulas on the same per-block
  arrays bit for bit, and G2's parents on them equal the JAX kernel's
  (``resample_gather_rows_u`` in interpret mode).
- Whole states: each block's total weight is kept, the LML is untouched,
  parents stay inside their block; rotation and shuffle are deterministic
  permutations and bit-equal to JAX's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import multi_object as jmot  # noqa: E402
from genparticlefilters_tpu.ops.fused_gather import (  # noqa: E402
    resample_gather_rows_u as jax_rows_u)
from genparticlefilters_tpu.parallel import distributed as jdist  # noqa
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import tree_take  # noqa
from genparticlefilters_tpu_torch.core.tree import tree_leaves  # noqa: E402
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from genparticlefilters_tpu_torch.models import multi_object as tmot  # noqa
from genparticlefilters_tpu_torch.ops.fused_gather import (  # noqa: E402
    resample_gather_split_u_plain)
from genparticlefilters_tpu_torch.smc import resample as tres  # noqa: E402

METHODS = ["systematic", "multinomial", "residual", "stratified"]


def _w_blocks(K, b, seed, alpha=0.7):
    w = np.random.default_rng(seed).dirichlet(np.full(b, alpha), size=K)
    return w.astype(np.float32)


def _leaves(jstate):
    return [np.array(x) for x in jax.tree_util.tree_flatten(jstate)[0]]


def _mot_pair(n=512, seed=0, t_max=3, k=2):
    y = np.random.default_rng(seed).normal(0.0, 1.5, (t_max, k, 2)).astype(
        np.float32)
    jst = jg.pf_initialize(
        jr.key(seed), jmot.make_mot_model(t_max, jmot.MOTParams(n_objects=k)),
        (t_max, jnp.zeros((k, 2), jnp.float32)),
        jmot.mot_obs_dense(jnp.asarray(y)), n)
    tst = state_from_numpy(
        tmot.make_mot_model(t_max, tmot.MOTParams(n_objects=k)),
        _leaves(jst), (t_max, torch.zeros((k, 2))),
        tmot.mot_obs_dense(torch.from_numpy(y)), device="cpu")
    return jst, tst


def test_systematic_compose_is_bit_identical_per_block():
    K, b = 8, 512
    w = torch.from_numpy(_w_blocks(K, b, 1))
    u0 = torch.from_numpy(np.random.default_rng(2).random(K).astype(
        np.float32))
    kind, F = tres.blockwise_compose(None, w, "systematic", u0=u0)
    assert kind == "F"
    parents = tres._F_to_parents(F, K * b).numpy()
    for k in range(K):
        Fk = tres.systematic_F(None, w[k], u0=u0[k])
        np.testing.assert_array_equal(F[k * b:(k + 1) * b].numpy(),
                                      Fk.numpy() + k * b)
        np.testing.assert_array_equal(parents[k * b:(k + 1) * b],
                                      tres._F_to_parents(Fk, b).numpy()
                                      + k * b)


@pytest.mark.parametrize("method", ["multinomial", "stratified"])
@pytest.mark.parametrize("K", [4, 3])
def test_bracket_compose_matches_jax_arithmetic(method, K):
    b = 512
    w = torch.from_numpy(_w_blocks(K, b, 3 + K))
    rng = np.random.default_rng(4)
    e = rng.exponential(size=(K, b + 1)).astype(np.float32)
    v = rng.random((K, b)).astype(np.float32)
    kind, (cg, ug) = tres.blockwise_compose(None, w, method, e=e, v=v)
    assert kind == "cu"
    # JAX's arithmetic (smc/resample.py blockwise_compose) in numpy float32
    # on the port's per-block brackets and queries from the same draws
    invK = np.float32(1.0 / K)
    floor = np.float32(max(K, 2) * 2.0 ** -21)
    ref_c, ref_u = [], []
    for k in range(K):
        c, u = (tres.multinomial_cu(None, w[k], e=e[k]) if method ==
                "multinomial" else tres.stratified_cu(None, w[k], v=v[k]))
        ref_c.append((np.float32(k) + c.numpy()) * invK)
        ref_u.append((np.float32(k) + np.maximum(u.numpy(), floor)) * invK)
    np.testing.assert_array_equal(cg.numpy(), np.concatenate(ref_c))
    np.testing.assert_array_equal(ug.numpy(), np.concatenate(ref_u))
    # G2 on the composed arrays == the JAX float-bracket kernel
    big = rng.integers(-2**31, 2**31, size=(5, K * b)).astype(np.int32)
    ref_out, ref_par = jax_rows_u(jnp.asarray(big), jnp.asarray(cg.numpy()),
                                  jnp.asarray(ug.numpy()), interpret=True)
    (out,), par = resample_gather_split_u_plain([torch.from_numpy(big)], cg,
                                                ug)
    np.testing.assert_array_equal(par.numpy(), np.asarray(ref_par))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    blk = par.numpy() // b
    np.testing.assert_array_equal(blk, np.repeat(np.arange(K), b))


def test_residual_compose_matches_jax_arithmetic():
    K, b = 4, 512
    wn = _w_blocks(K, b, 8, alpha=0.6)
    wn[:, 3:6] = 0.0
    w = torch.from_numpy((wn / wn.sum(axis=1, keepdims=True)).astype(
        np.float32))
    e = np.random.default_rng(9).exponential(size=(K, b + 1)).astype(
        np.float32)
    kind, F = tres.blockwise_compose(None, w, "residual", e=e)
    assert kind == "F"
    invK = np.float32(1.0 / K)
    floor = np.float32(max(K, 2) * 2.0 ** -22)
    ug, rcg, dets = [], [], []
    for k in range(K):
        det, n_res, resid = tres._residual_split(w[k], b)
        rc = tres._normalized(torch.cummax(torch.cumsum(resid, 0), 0).values)
        ce = torch.cummax(torch.cumsum(torch.from_numpy(e[k]), 0), 0).values
        u = tres._residual_u(ce, n_res, b).numpy()
        ug.append((np.float32(k) + np.float32(0.5) * u) * invK)
        rcg.append((np.float32(k) + np.float32(0.5)
                    * np.maximum(rc.numpy(), floor)) * invK)
        dets.append(det.numpy())
    # the remainder count: JAX's kernel with zero rows, roles swapped
    _, gidx = jax_rows_u(jnp.zeros((0, K * b), jnp.int32),
                         jnp.asarray(np.concatenate(ug)),
                         jnp.asarray(np.concatenate(rcg)), interpret=True)
    G = np.asarray(gidx).reshape(K, b) - (np.arange(K) * b)[:, None]
    Fb = np.cumsum(np.stack(dets), axis=1) + G
    Fb = np.maximum.accumulate(np.clip(Fb, 0, b), axis=1)
    Fb[:, -1] = b
    np.testing.assert_array_equal(
        F.numpy(), (Fb + (np.arange(K) * b)[:, None]).reshape(-1))
    # every block's ⌊b·w⌋ deterministic copies survive
    counts = np.diff(F.numpy(), prepend=0).reshape(K, b)
    assert (counts >= np.stack(dets)).all()


@pytest.mark.parametrize("method,variant", [
    (m, v) for m in METHODS for v in ("default", "priority")]
    + [("stratified", "unsorted")])
def test_blockwise_resample_semantics(method, variant):
    _, st = _mot_pair()
    K, b = 8, 64
    kw = {"priority_fn": lambda w: w / 2} if variant == "priority" else {}
    if variant == "unsorted":
        kw["sort_particles"] = False
    out = tg.pf_resample_blockwise(torch.Generator().manual_seed(1), st, K,
                                   method, **kw)
    tol = 1e-3 if variant == "priority" else 1e-4
    for k in range(K):
        blk = slice(k * b, (k + 1) * b)
        np.testing.assert_allclose(
            float(torch.logsumexp(out.log_weights[blk], 0)),
            float(torch.logsumexp(st.log_weights[blk], 0)), atol=tol)
        par = out.parents[blk].numpy()
        assert ((par >= k * b) & (par < (k + 1) * b)).all()
    assert torch.equal(out.log_ml_est, st.log_ml_est)
    np.testing.assert_allclose(float(tg.log_ml_estimate(out)),
                               float(tg.log_ml_estimate(st)), atol=1e-4)
    assert all(torch.equal(a, c) for a, c in zip(
        tree_leaves(tree_take(st.traces, out.parents)),
        tree_leaves(out.traces)) if isinstance(a, torch.Tensor))


def test_resample_block_keeps_the_block_total():
    _, st = _mot_pair(n=128)
    lw = st.log_weights
    for kw in ({"F_fn": lambda g, w: tres.systematic_F(g, w, u0=0.3)},
               {"cu_fn": lambda g, w: tres.multinomial_cu(g, w)}, {}):
        traces, parents, new_lw = tres._resample_block(
            torch.Generator().manual_seed(2), st.traces, lw,
            lambda g, w, lp: tres.stratified_parents(g, w,
                                                     log_priorities=lp),
            **kw)
        np.testing.assert_allclose(float(torch.logsumexp(new_lw, 0)),
                                   float(torch.logsumexp(lw, 0)), atol=1e-4)
        assert all(torch.equal(a, c) for a, c in zip(
            tree_leaves(tree_take(st.traces, parents)), tree_leaves(traces))
            if isinstance(a, torch.Tensor))


@pytest.mark.parametrize("op", ["rotate1", "rotate3", "shuffle"])
def test_rotate_and_shuffle_match_jax(op):
    jst, tst = _mot_pair(n=256, seed=5)
    K = 4
    if op == "shuffle":
        jout, tout = jdist.pf_shuffle_blocks(jst, K), tg.pf_shuffle_blocks(
            tst, K)
    else:
        s = int(op[-1])
        jout = jdist.pf_rotate_blocks(jst, K, s)
        tout = tg.pf_rotate_blocks(tst, K, s)
    a, b = _leaves(jout), state_to_numpy(tout)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x, err_msg=f"leaf {i}")
    np.testing.assert_array_equal(
        np.sort(tout.log_weights.numpy()), np.sort(tst.log_weights.numpy()))
    np.testing.assert_allclose(
        float(tg.block_log_weight_imbalance(tst, K)),
        float(jdist.block_log_weight_imbalance(jst, K)), atol=1e-5)


def test_errors(tmp_path):
    _, st = _mot_pair(n=96)
    with pytest.raises(TypeError, match="ParticleMesh"):
        tg.pf_resample_blockwise(None, st, 4, mesh=object())
    with pytest.raises(TypeError, match="ParticleMesh"):
        tg.pf_rotate_blocks(st, 4, mesh=object())
    # a mesh whose size is not n_blocks (one rank, four blocks)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = tg.parallel.particle_mesh()
        sh = tg.parallel.shard_state(st, mesh)
        for op in (lambda: tg.pf_rotate_blocks(sh, 4, mesh=mesh),
                   lambda: tg.pf_shuffle_blocks(sh, 4, mesh=mesh),
                   lambda: tg.pf_resample_blockwise(None, sh, 4, mesh=mesh)):
            with pytest.raises(ValueError, match="1 devices but n_blocks=4"):
                op()
        with pytest.raises(ValueError, match="not sharded over this mesh"):
            tg.pf_rotate_blocks(st, 1, mesh=mesh)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="divisible"):
        tg.pf_resample_blockwise(None, st, 5)
    with pytest.raises(ValueError, match="equal splits"):
        tg.pf_shuffle_blocks(st, 8)
    with pytest.raises(ValueError, match="not recognized"):
        tg.pf_resample_blockwise(None, st, 4, "bogus")
