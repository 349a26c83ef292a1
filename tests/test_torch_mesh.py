"""The parallel layer's mesh half (genparticlefilters_tpu_torch/parallel/
mesh.py, the mesh branches of parallel/distributed.py, the global
reductions of smc/state.py and smc/statistics.py, the global resample of
smc/resample.py) on a 4-rank gloo group on the CPU, mirroring
tests/test_parallel.py and tests/test_collectives.py.

One group of four worker processes runs every scenario once per module
(this file run as a script, one process per rank, ``file://`` rendezvous
in a temporary directory) on an object-motion state carried over from the
JAX package. The test process assembles the ranks' blocks along each
leaf's particle axis and holds them:

- bit-equal to the port's one-device form (``mesh=None``) given the same
  state and draws: rotate, shuffle, blockwise resampling (every method,
  with a ``priority_fn``, unsorted stratified) and the exact global
  ``pf_resample``; rotate and shuffle also bit-equal to JAX's
  ``mesh=None`` functions;
- the blockwise body makes no ``torch.distributed`` call at all (every
  function of the module is counted); rotate is a ring, shuffle an
  all-to-all, the global resample an all-gather plus an all-to-all;
- the global ESS, LML, normalized weights and weighted statistics of a
  sharded SMC step equal those of the assembled state; every rank takes
  the same ESS branch of the sharded SMC step of ``dryrun_multichip``
  (update, blockwise + rotate, MH, global resample, translator update);
- leaf placement: particle-axis leaves cut at their own axis (the packed
  store on axis 1), shared leaves and the LML replicated;
- E[exp(LML)] = Z over 60 seeds of the composed scheme (blockwise +
  rotate + Extend) against the Kalman evidence;
- a mesh whose size is not ``n_blocks`` raises.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.core.tree import tree_leaves
from genparticlefilters_tpu_torch.interop import (state_from_numpy,
                                                  state_to_numpy)
from genparticlefilters_tpu_torch.models import object_motion as tom

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
N, T = 256, 4
METHODS = ["systematic", "multinomial", "residual", "stratified"]
BLOCK_CASES = ([(m, "default") for m in METHODS]
               + [(m, "priority") for m in METHODS]
               + [("stratified", "unsorted")])
GLOBAL_CASES = METHODS + ["stratified_unsorted", "systematic_priority"]
#: the functions of torch.distributed counted (``isend``/``irecv`` are
#: named by a ``P2POp`` and run by ``batch_isend_irecv``, counted here)
DIST_FNS = ("all_gather", "all_gather_into_tensor", "all_gather_object",
            "all_reduce", "all_to_all", "all_to_all_single", "broadcast",
            "batch_isend_irecv", "send", "recv", "reduce", "reduce_scatter",
            "scatter", "gather", "barrier")


def G(seed):
    return torch.Generator().manual_seed(seed)


def _model():
    return tom.make_object_motion(T)


def _obs(y):
    return tom.obs_dense(torch.from_numpy(np.array(y, np.float32)))


def _base(arrays, y):
    """The port's state holding the JAX state's leaves."""
    return state_from_numpy(_model(), arrays, (2, tom.init_state("cpu")),
                            _obs(y), device="cpu")


def _block_kw(variant):
    kw = {}
    if variant == "priority":
        kw["priority_fn"] = lambda w: w / 2
    if variant == "unsorted":
        kw["sort_particles"] = False
    return kw


def _global_kw(case):
    if case == "stratified_unsorted":
        return "stratified", {"sort_particles": False}
    if case == "systematic_priority":
        return "systematic", {"priority_fn": lambda w: w / 2}
    return case, {}


# ---------------------------------------------------------------------------
# The worker: one process per rank
# ---------------------------------------------------------------------------

class _DistCalls:
    """Counts every call of the functions of torch.distributed named in
    ``DIST_FNS`` while active."""

    def __init__(self):
        self.count = 0
        self.saved = {}

    def __enter__(self):
        import torch.distributed as dist
        for name in DIST_FNS:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def wrapped(*a, _fn=fn, **k):
                self.count += 1
                return _fn(*a, **k)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)
        return False


def _worker(rank, world, init_file, out_dir):
    import torch.distributed as dist
    from genparticlefilters_tpu_torch.parallel import mesh as pm
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        with open(Path(out_dir) / "base.pkl", "rb") as f:
            base_in = pickle.load(f)
        base = _base(base_in["arrays"], base_in["y"])
        mesh = tg.parallel.particle_mesh()
        sh = tg.parallel.shard_state(base, mesh)
        res = {"placement": {
            "leaves": state_to_numpy(sh),
            "pspecs": [tuple(p) for p in tree_leaves(
                tg.parallel.state_pspecs(base), is_leaf=lambda x: isinstance(
                    x, pm.PartitionSpec))],
            "replicated": tg.parallel.replicated_sharding(
                mesh).is_fully_replicated,
            "n": (sh.n_particles, tg.num_particles(sh))}}

        def run(name, fn):
            before = dict(pm.COLLECTIVES)
            with _DistCalls() as calls:
                out = fn()
            res[name] = {"leaves": state_to_numpy(out),
                         "dist_calls": calls.count,
                         "collectives": {k: pm.COLLECTIVES[k] - before[k]
                                         for k in before}}

        for shift in (1, 3):
            run(f"rotate{shift}",
                lambda: tg.pf_rotate_blocks(sh, WORLD, shift, mesh=mesh))
        run("shuffle", lambda: tg.pf_shuffle_blocks(sh, WORLD, mesh=mesh))
        for method, variant in BLOCK_CASES:
            run(f"block_{method}_{variant}",
                lambda: tg.pf_resample_blockwise(
                    G(1), sh, WORLD, method, mesh=mesh,
                    **_block_kw(variant)))
        for case in GLOBAL_CASES:
            method, kw = _global_kw(case)
            # every rank's gen alike here; the first rank's draws decide
            run(f"global_{case}",
                lambda: tg.pf_resample(G(7), sh, method, check=False, **kw))

        # a sharded SMC step: per-rank draws in the update
        y = base_in["y"]
        s = tg.pf_update(G(10 + rank), sh, (3, tom.init_state("cpu")),
                         (tg.Extend(1), tg.NoChange()), _obs(y), check=False)
        s = tg.pf_resample_blockwise(G(11 + rank), s, WORLD, mesh=mesh)
        res["step"] = {
            "leaves": state_to_numpy(s),
            "ess": float(tg.effective_sample_size(s)),
            "lml": float(tg.log_ml_estimate(s)),
            "norm_w": tg.get_norm_weights(s).numpy(),
            "log_norm_w": tg.get_log_norm_weights(s).numpy(),
            "mean": float(tg.mean(s, (2, "y"))),
            "var": float(tg.var(s, (2, "y"))),
            "pmap": tg.proportionmap(s, (2, "moving")),
            "imbalance": float(tg.block_log_weight_imbalance(s, WORLD))}
        res["dryrun"] = _dryrun(rank, sh, mesh, y)
        res["lml"] = _lml_seeds(rank, mesh)
        try:
            tg.pf_rotate_blocks(sh, 2, 1, mesh=mesh)
            res["mismatch"] = None
        except ValueError as e:
            res["mismatch"] = str(e)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@tg.gen
def _flip_moving(tr, t):
    tg.trace((t, "moving"), tg.bernoulli(0.5))


_flip_moving.batch_safe = True


def _dryrun(rank, sh, mesh, y):
    """The step of ``dryrun_multichip`` (__graft_entry__.py) on a sharded
    state: update, ESS-triggered blockwise resample + ring rotation, MH,
    the exact global resample and a translator update."""
    x0 = tom.init_state("cpu")
    g = G(20 + rank)
    s = tg.pf_update(g, sh, (3, x0), (tg.UnknownChange(), tg.NoChange()),
                     _obs(y), check=False)
    ess = float(tg.effective_sample_size(s))
    low = ess < 0.75 * N
    if low:
        s = tg.pf_resample_blockwise(g, s, WORLD, "systematic", mesh=mesh)
        s = tg.pf_rotate_blocks(s, WORLD, 1, mesh=mesh)
    steps = torch.arange(T)
    sel = tg.Selection({("moving",): steps <= 1, ("y",): steps <= 1})
    s = tg.pf_rejuvenate(g, s, tg.mh, (sel,))
    s = tg.pf_resample(g, s, "systematic", check=False)
    s = tg.pf_update(g, s, (4, x0), (tg.UnknownChange(), tg.NoChange()),
                     _obs(y), proposal=_flip_moving, proposal_args=(3,),
                     check=False)
    return {"ess": ess, "low": low, "lml": float(tg.log_ml_estimate(s)),
            "leaves": state_to_numpy(s)}


def _lml_seeds(rank, mesh, n_seeds=60, T_lg=5, n=256):
    """The composed distributed scheme of tests/test_parallel.py:145-183:
    T steps of blockwise resampling + ring rotation + an Extend update on
    the linear-Gaussian model, per-rank draws, the global LML per seed."""
    from genparticlefilters_tpu_torch.models import linear_gaussian as lg
    p = lg.LGParams(a=0.7, q=0.6, r=0.5)
    y = lg.synthesize_lg_data(G(0), T_lg, p)
    model = lg.make_lgssm(T_lg, p)
    obs = lg.lg_obs_dense(y)
    x0 = torch.zeros(())
    out = []
    for seed in range(n_seeds):
        g = G(1000 * seed + rank)
        st = tg.pf_initialize(g, model, (1, x0), obs, n // WORLD)
        st = st.replace(mesh=mesh)
        for t in range(1, T_lg):
            st = tg.pf_resample_blockwise(g, st, WORLD, "systematic")
            st = tg.pf_rotate_blocks(st, WORLD, 1)
            st = tg.pf_update(g, st, (t + 1, x0), (tg.Extend(1),
                                                   tg.NoChange()),
                              obs, check=False)
        out.append(float(tg.log_ml_estimate(st)))
    return {"lmls": out, "y": y.numpy(),
            "lml_exact": lg.kalman_filter(y.numpy(), p)[2]}


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])


# ---------------------------------------------------------------------------
# The tests: one 4-rank run per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(base JAX state, base port state, y, per-rank results)."""
    jax = pytest.importorskip("jax")
    import jax.random as jr
    import genparticlefilters_tpu as jg
    from genparticlefilters_tpu.models import object_motion as jom
    d = tmp_path_factory.mktemp("mesh")
    y, _ = jom.synthesize_data(jr.key(42), T, 2)
    jst = jg.pf_initialize(jr.key(3), jom.make_object_motion(T),
                           (2, jom.init_state()), jom.obs_dense(y), N)
    arrays = [np.asarray(x) for x in jax.tree_util.tree_leaves(jst)]
    y = np.asarray(y)
    with open(d / "base.pkl", "wb") as f:
        pickle.dump({"arrays": arrays, "y": y}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), str(d / "pg"),
         str(d)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    res = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return jst, _base(arrays, y), y, res


def _assemble(per_rank, ref):
    """The ranks' leaves joined along each leaf's particle axis (the
    reference state's specs); replicated leaves must agree on every
    rank."""
    from genparticlefilters_tpu_torch.parallel import mesh as pm
    specs = tree_leaves(tg.parallel.state_pspecs(ref),
                           is_leaf=lambda x: isinstance(x, pm.PartitionSpec))
    out = []
    for i, spec in enumerate(specs):
        parts = [np.asarray(r[i]) for r in per_rank]
        if spec.dim is None:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
            out.append(parts[0])
        else:
            out.append(np.concatenate(parts, spec.dim))
    return out


def _assert_leaves_equal(got, ref_state):
    ref = state_to_numpy(ref_state)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def _leaves(world, name):
    return [r[name]["leaves"] for r in world[3]]


@pytest.mark.parametrize("shift", [1, 3])
def test_rotate_matches_unsharded_and_jax(world, shift):
    jst, base, _, res = world
    from genparticlefilters_tpu.parallel import distributed as jdist
    got = _assemble(_leaves(world, f"rotate{shift}"), base)
    _assert_leaves_equal(got, tg.pf_rotate_blocks(base, WORLD, shift))
    jout = jdist.pf_rotate_blocks(jst, WORLD, shift)
    import jax
    for a, b in zip(got, jax.tree_util.tree_leaves(jout)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for r in res:
        assert r[f"rotate{shift}"]["collectives"]["ring"] == 1
        assert sum(r[f"rotate{shift}"]["collectives"].values()) == 1


def test_shuffle_matches_unsharded_and_jax(world):
    jst, base, _, res = world
    from genparticlefilters_tpu.parallel import distributed as jdist
    import jax
    got = _assemble(_leaves(world, "shuffle"), base)
    _assert_leaves_equal(got, tg.pf_shuffle_blocks(base, WORLD))
    for a, b in zip(got, jax.tree_util.tree_leaves(
            jdist.pf_shuffle_blocks(jst, WORLD))):
        np.testing.assert_array_equal(a, np.asarray(b))
    # one all_to_all_single per moving leaf (and the log weights)
    n_moving = sum(p.dim is not None for p in tree_leaves(
        tg.parallel.state_pspecs(base.traces, n=N),
        is_leaf=lambda x: type(x).__name__ == "PartitionSpec"))
    for r in res:
        assert r["shuffle"]["collectives"]["all_to_all"] == n_moving + 1


@pytest.mark.parametrize("method,variant", BLOCK_CASES)
def test_blockwise_is_collective_free_and_matches_unsharded(world, method,
                                                            variant):
    _, base, _, res = world
    name = f"block_{method}_{variant}"
    got = _assemble(_leaves(world, name), base)
    _assert_leaves_equal(got, tg.pf_resample_blockwise(
        G(1), base, WORLD, method, **_block_kw(variant)))
    for r in res:
        assert r[name]["dist_calls"] == 0
        assert sum(r[name]["collectives"].values()) == 0


@pytest.mark.parametrize("case", GLOBAL_CASES)
def test_global_resample_sharded_matches_unsharded(world, case):
    """The exact global resample of a sharded state equals the unsharded
    one bit for bit (parents, weights, LML, every trace leaf)."""
    _, base, _, res = world
    method, kw = _global_kw(case)
    got = _assemble(_leaves(world, f"global_{case}"), base)
    _assert_leaves_equal(got, tg.pf_resample(G(7), base, method,
                                             check=False, **kw))
    sorted_route = case == "stratified"
    for r in res:
        c = r[f"global_{case}"]["collectives"]
        assert c["all_gather"] == (2 if sorted_route else 1)
        assert c["broadcast"] == 1
        assert c["all_to_all"] == (0 if sorted_route else 1)


def _assembled_state(world, name):
    _, base, y, _ = world
    got = _assemble(_leaves(world, name), base)
    model = _model()
    return state_from_numpy(model, got, (3, tom.init_state("cpu")),
                            _obs(y), device="cpu")


def test_sharded_smc_step_global_reductions(world):
    """After a sharded update + blockwise resample: the global ESS, LML,
    normalized weights, weighted mean, variance and proportion map that
    every rank computes equal those of the assembled state."""
    res = world[3]
    full = _assembled_state(world, "step")
    for key in ("ess", "lml", "mean", "var", "imbalance"):
        vals = [r["step"][key] for r in res]
        assert len(set(vals)) == 1, (key, vals)
    r0 = res[0]["step"]
    np.testing.assert_allclose(r0["ess"],
                               float(tg.effective_sample_size(full)),
                               rtol=1e-5)
    np.testing.assert_allclose(r0["lml"], float(tg.log_ml_estimate(full)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.concatenate([r["step"]["norm_w"] for r in res]),
        tg.get_norm_weights(full).numpy(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        np.concatenate([r["step"]["log_norm_w"] for r in res]),
        tg.get_log_norm_weights(full).numpy(), atol=1e-5)
    np.testing.assert_allclose(r0["mean"], float(tg.mean(full, (2, "y"))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["var"], float(tg.var(full, (2, "y"))),
                               rtol=1e-4, atol=1e-7)
    pm = tg.proportionmap(full, (2, "moving"))
    assert set(r0["pmap"]) == set(pm)
    for k in pm:
        np.testing.assert_allclose(r0["pmap"][k], pm[k], atol=1e-6)
    np.testing.assert_allclose(
        r0["imbalance"], float(tg.block_log_weight_imbalance(full, WORLD)),
        atol=1e-5)


def test_dryrun_step_on_a_sharded_state(world):
    """The ``dryrun_multichip`` step runs on the sharded state: every rank
    takes the same ESS branch and ends with the same LML, the global
    resample leaves every rank's parents global and sorted, and the
    assembled state's LML is the one each rank computed."""
    res = world[3]
    d = [r["dryrun"] for r in res]
    assert len({x["low"] for x in d}) == 1
    assert len({x["ess"] for x in d}) == 1
    assert len({x["lml"] for x in d}) == 1
    assert np.isfinite(d[0]["lml"])
    full = _assembled_state(world, "dryrun")
    np.testing.assert_allclose(d[0]["lml"], float(tg.log_ml_estimate(full)),
                               rtol=1e-5, atol=1e-5)


def test_leaf_placement(world):
    """``shard_state``: each particle-axis leaf is this rank's block cut
    at its own axis (the packed ``mat [T*R, N]`` on axis 1), shared
    leaves and the LML replicated; ``state_pspecs`` names the axis."""
    _, base, _, res = world
    got = _assemble([r["placement"]["leaves"] for r in res], base)
    _assert_leaves_equal(got, base)
    p = res[0]["placement"]
    assert p["n"] == (N // WORLD, N)
    assert p["replicated"]
    specs = p["pspecs"]
    leaves = state_to_numpy(base)
    mat = next(i for i, x in enumerate(leaves) if x.ndim == 2)
    assert specs[mat] == (None, "p")
    assert specs[-1] == ("p",) and specs[-3] == ("p",)   # parents, weights
    assert specs[-2] == ()                                # the LML
    for r in res:
        local = r["placement"]["leaves"]
        assert local[mat].shape == (leaves[mat].shape[0], N // WORLD)
        np.testing.assert_array_equal(local[-2], leaves[-2])


def test_distributed_lml_unbiasedness(world):
    """E[exp(LML_hat)] = Z for blockwise resampling + ring rotation +
    Extend updates over 4 ranks (60 seeds), against the Kalman evidence."""
    lml = world[3][0]["lml"]
    for r in world[3][1:]:
        assert r["lml"]["lmls"] == lml["lmls"]
    z_hat = np.exp(np.asarray(lml["lmls"], np.float64) - lml["lml_exact"])
    stderr = z_hat.std() / np.sqrt(len(z_hat))
    assert abs(z_hat.mean() - 1.0) < 4 * stderr + 0.05, (z_hat.mean(),
                                                         stderr)


def test_mesh_size_mismatch_raises(world):
    for r in world[3]:
        assert "4 devices but n_blocks=2" in r["mismatch"]
