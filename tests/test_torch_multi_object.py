"""The multi-object tracking model (BASELINE config 5,
genparticlefilters_tpu_torch/models/multi_object.py) against the JAX
package: a K=4 state crosses ``interop`` bit for bit, the packed storage
has JAX's row count, a fully constrained ``generate`` gives JAX's weight
(float32 log densities, atol 1e-4), and the filters hold the checks of
tests/test_models.py (posterior mean near the last observation, LML kept
by a residual resize, data associations recovered)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import multi_object as jmot  # noqa: E402
from genparticlefilters_tpu.smc import resample as jres  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.batching import (  # noqa: E402
    flatten_with_axes)
from genparticlefilters_tpu_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from genparticlefilters_tpu_torch.models import multi_object as tmot  # noqa
from genparticlefilters_tpu_torch.smc import resample as tres  # noqa: E402


def _leaves(jstate):
    return [np.array(x) for x in jax.tree_util.tree_flatten(jstate)[0]]


def _pair(t_max, n, seed=0, k=4):
    y = np.random.default_rng(seed).normal(0.0, 2.0, (t_max, k, 2)).astype(
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


def _rows(leaves, axes):
    return sum(r.shape[0] for r in tres._pack_rows(leaves, axes)[0]
               if r is not None)


def test_interop_round_trip_of_a_mot_state():
    jst, tst = _pair(10, 64)
    a, b = _leaves(jst), state_to_numpy(tst)
    assert len(a) == len(b) == 9
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x, err_msg=f"leaf {i}")
    assert tuple(tst.traces.inner["store"].mat.shape) == (160, 64)


def test_state_from_numpy_defaults_to_the_card():
    # without ``device`` the state is built on the card, never quietly on
    # the CPU: with no card the call raises
    y = np.random.default_rng(0).normal(0.0, 2.0, (4, 4, 2)).astype(
        np.float32)
    jst = jg.pf_initialize(jr.key(0), jmot.make_mot_model(4, jmot.MOTParams()),
                           (4, jnp.zeros((4, 2), jnp.float32)),
                           jmot.mot_obs_dense(jnp.asarray(y)), 16)
    args = (tmot.make_mot_model(4, tmot.MOTParams()), _leaves(jst),
            (4, torch.zeros((4, 2))), tmot.mot_obs_dense(torch.from_numpy(y)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            state_from_numpy(*args)
        return
    st = state_from_numpy(*args)
    assert st.log_weights.device.type == "cuda"
    assert st.traces.inner["store"].mat.device.type == "cuda"


@pytest.mark.parametrize("t_max,rows", [(10, 161), (64, 1025)])
def test_pack_width_matches_jax(t_max, rows):
    # 16 rows per step at K=4 plus the score; with JAX's index row these
    # are the 162 and 1026 rows of its lane-kernel route decision
    jst, tst = _pair(t_max, 32, seed=t_max)
    jleaves, jaxes, _ = jres._flatten_with_axes(jst.traces)
    jrows = sum(r.shape[0] for r in jres._pack_rows(jleaves, jaxes)[0]
                if r is not None)
    assert _rows(*flatten_with_axes(tst.traces)[:2]) == jrows == rows


@pytest.mark.parametrize("da", [False, True])
def test_constrained_generate_weight_matches_jax(da):
    t_max, k, n = 5, 3, 16
    rng = np.random.default_rng(3)
    # a random walk from the prior: moderate log densities, so float32
    # sums in another order agree to atol 1e-4
    xs = np.cumsum(rng.normal(0.0, 0.3, (t_max, k, 2)), axis=0)
    xs = (xs + rng.normal(0.0, 2.0, (1, k, 2))).astype(np.float32)
    assoc = np.stack([rng.permutation(k) for _ in range(t_max)]).astype(
        np.int32)
    # slot j observes object assoc[j] (the identity without association)
    src = np.take_along_axis(xs, assoc[..., None], axis=1) if da else xs
    ys = (src + rng.normal(0.0, 0.5, xs.shape)).astype(np.float32)
    anchors = np.array([[-1.0, 0.0], [0.0, 1.0], [1.0, -1.0]], np.float32)
    mask = np.ones((t_max,), bool)
    entries = {"x": xs, "y": ys}
    if da:
        entries["assoc"] = assoc
    jp, tp = jmot.MOTParams(n_objects=k), tmot.MOTParams(n_objects=k)
    jmodel = (jmot.make_mot_da_model(t_max, jp, jnp.asarray(anchors)) if da
              else jmot.make_mot_model(t_max, jp))
    tmodel = (tmot.make_mot_da_model(t_max, tp, anchors) if da
              else tmot.make_mot_model(t_max, tp))
    jcm = jg.ChoiceMap({(a,): jg.Entry(jnp.asarray(v), jnp.asarray(mask))
                        for a, v in entries.items()})
    tcm = tg.ChoiceMap({(a,): tg.Entry(torch.from_numpy(v),
                                       torch.from_numpy(mask))
                        for a, v in entries.items()})
    jst = jg.pf_initialize(jr.key(0), jmodel,
                           (t_max, jnp.zeros((k, 2), jnp.float32)), jcm, n)
    tst = tg.pf_initialize(torch.Generator().manual_seed(0), tmodel,
                           (t_max, torch.zeros((k, 2))), tcm, n)
    np.testing.assert_allclose(tst.log_weights.numpy(),
                               np.asarray(jst.log_weights), atol=1e-4,
                               rtol=0)
    assert torch.equal(tst.log_weights, tst.log_weights[:1].expand(n))
    np.testing.assert_array_equal(
        tg.batched_choice(tst, (t_max - 1, "x")).numpy(),
        np.broadcast_to(xs[-1], (n, k, 2)))


def test_mot_filter_posterior_and_resize():
    # tests/test_models.py:82-96 on the port
    t_max = 8
    p = tmot.MOTParams(n_objects=3)
    y = tmot.synthesize_mot_data(torch.Generator().manual_seed(4), t_max, p)
    assert tuple(y.shape) == (t_max, 3, 2)
    st = tmot.mot_particle_filter(torch.Generator().manual_seed(5), y, 4000,
                                  t_max, p)
    x_mean = tg.mean(st, (t_max - 1, "x")).numpy()
    assert np.all(np.abs(x_mean - y[t_max - 1].numpy()) < 3 * p.r)
    st2 = tg.pf_resize(torch.Generator().manual_seed(6), st, 2000,
                       "residual")
    assert st2.n_particles == 2000
    np.testing.assert_allclose(float(tg.log_ml_estimate(st2)),
                               float(tg.log_ml_estimate(st)), atol=1e-3)


def test_mot_data_association():
    # tests/test_models.py:99-123 on the port
    p = tmot.MOTParams(n_objects=3, q=0.05, r=0.1, s0=0.5)
    t_max = 5
    rng = np.random.default_rng(7)
    x_true = torch.tensor([[-4.0, 0.0], [0.0, 4.0], [4.0, -4.0]])
    perms = np.stack([rng.permutation(3) for _ in range(t_max)])
    y = x_true[torch.from_numpy(perms)] + 0.05 * torch.from_numpy(
        rng.normal(size=(t_max, 3, 2)).astype(np.float32))
    st = tmot.mot_da_particle_filter(torch.Generator().manual_seed(8), y,
                                     3000, t_max, p, 0.5, x_true)
    assoc = tg.batched_choice(st, (t_max - 1, "assoc"))  # [N, 3]
    assert assoc.dtype == torch.int32
    w = tg.get_norm_weights(st)
    for j in range(3):
        counts = [float(w[assoc[:, j] == o].sum()) for o in range(3)]
        assert int(np.argmax(counts)) == int(perms[t_max - 1][j])
    y_sim, a_sim = tmot.synthesize_mot_da_data(
        torch.Generator().manual_seed(9), t_max, p, x_true)
    assert tuple(y_sim.shape) == (t_max, 3, 2)
    assert tuple(a_sim.shape) == (t_max, 3)
    assert bool(((a_sim >= 0) & (a_sim < 3)).all())
