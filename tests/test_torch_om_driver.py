"""The headline filter through the shared driver: ``object_motion_filter_impl``
is ``run_particle_filter`` on the object-motion model, held here to a copy
of the loop it kept of its own before (``_own_loop``).

On the CPU: eager runs bit-equal to the copy's, systematic and residual, at
ess_frac 0, 0.5 and 1.5, with the same host reads of the predicate and the
same store writes.

Marked ``chip``, on the card (this file imports no JAX: run it there with
``python -m pytest --noconftest tests/test_torch_om_driver.py -m chip``):
captured at N=100K systematic and N=1M residual, T=10, the graph holds the
copy's nodes, kernels and conditional nodes, its IF nodes the same forms,
and the capture the same store writes; the replays from one seed are
bit-equal. The captures' pool bytes are printed, not compared: they follow
the process's history (when the cyclic collector runs, what the allocator
holds), not only the graph.
"""

import importlib

import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.core.gfi import Extend, NoChange
from genparticlefilters_tpu_torch.core.packed import STORE_WRITES
from genparticlefilters_tpu_torch.core.tree import tree_flatten
from genparticlefilters_tpu_torch.models import object_motion as om
from genparticlefilters_tpu_torch.ops.ess_check import ess_below
from genparticlefilters_tpu_torch.smc.capture import device_cond, host_pred
from genparticlefilters_tpu_torch.utils.spans import span

# the module (the package's ``smc.capture`` attribute is the function)
cap = importlib.import_module("genparticlefilters_tpu_torch.smc.capture")

T = 10


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda")


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _assert_same(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f"leaf {i}"
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x.cpu(), y.cpu()), f"leaf {i}"
        else:
            assert x == y, f"leaf {i}"


def _own_loop(gen, y_obs, n_particles, t_max, ess_frac=0.5,
              resample_method="residual", batch_safe=True):
    """The filter loop ``object_motion_filter_impl`` held of its own."""
    device = gen.device
    y_obs = torch.as_tensor(y_obs, dtype=torch.float32, device=device)
    model = om.make_object_motion(t_max, batch_safe)
    x0 = om.init_state(device)
    obs = om.obs_dense(y_obs)
    with span("om.initialize"):
        state = tg.pf_initialize(gen, model, (1, x0), obs, n_particles)
    steps = torch.arange(t_max, device=device)

    def resample_rejuvenate(state, t):
        with span("om.resample"):
            state = tg.pf_resample(gen, state, resample_method, check=False)
        with span("om.rejuvenate"):
            sel_mask = (steps == t - 1) | (steps == t)
            sel = tg.Selection({("moving",): sel_mask, ("y",): sel_mask})
            return tg.pf_rejuvenate(gen, state, tg.mh, (sel,), window=2)

    for t in range(1, t_max):
        with span("om.ess_check"):
            low = host_pred(ess_below(state.log_weights,
                                      ess_frac * n_particles))
        state = device_cond(low, lambda s: resample_rejuvenate(s, t), state,
                            donate=True)
        with span("om.update"):
            state = tg.pf_update(gen, state, (t + 1, x0),
                                 (Extend(1), NoChange()), obs, check=False,
                                 donate=True)
    return state


def _counted(fn, y, n, ess_frac, method):
    """``fn``'s eager run and the host reads and store writes it made."""
    reads, writes = host_pred.reads, dict(STORE_WRITES)
    out = fn(_gen(3), y, n, T, ess_frac, method)
    return out, host_pred.reads - reads, {k: STORE_WRITES[k] - v
                                          for k, v in writes.items()}


@pytest.mark.parametrize("ess_frac", [0.0, 0.5, 1.5])
@pytest.mark.parametrize("method", ["systematic", "residual"])
def test_the_driver_runs_the_own_loop_eagerly(method, ess_frac):
    y, _ = om.synthesize_data(_gen(42), T, 3)
    got, reads, writes = _counted(om.object_motion_filter_impl, y, 256,
                                  ess_frac, method)
    want, reads0, writes0 = _counted(_own_loop, y, 256, ess_frac, method)
    _assert_same(got, want)
    assert reads == reads0 == T - 1
    assert writes == writes0 == {"copied": 0, "in_place": T}


@pytest.mark.chip
@pytest.mark.parametrize("n,method", [(100_000, "systematic"),
                                      (1_000_000, "residual")])
def test_the_captured_driver_is_the_own_loops_graph(card, n, method):
    from genparticlefilters_tpu_torch.utils.spans import _graph_nodes
    y, _ = om.synthesize_data(_gen(42, card), T, 3)
    found, outs = {}, {}
    for name, fn in (("own loop", _own_loop),
                     ("driver", om.object_motion_filter_impl)):
        counts = []

        def counted(*a, fn=fn, **k):
            out = fn(*a, **k)
            if torch.cuda.is_current_stream_capturing():
                counts.append(_graph_nodes(
                    [g for nd in cap._BODIES[-1].nodes for g in nd.graphs]))
            return out
        counted.__name__ = fn.__name__
        gen = _gen(0, card)
        run = cap.capture(counted, gen, y, n, T, resample_method=method)
        gen.manual_seed(11)
        outs[name] = run(y)
        torch.cuda.synchronize()
        found[name] = {"graph": counts[-1], "if_nodes": run.nodes,
                       "forms": run.forms, "store_writes": run.store_writes}
        print(n, method, name, found[name], "pool_bytes", run.pool_bytes)
        del run
        torch.cuda.empty_cache()
    assert found["driver"] == found["own loop"], found
    assert found["driver"]["graph"]["conditionals"] == T - 1
    _assert_same(outs["driver"], outs["own loop"])
