"""The compiled drivers (genparticlefilters_tpu_torch/smc/capture.py and the
drivers that use it) on the CPU, against today's host-``if`` loops and the
JAX package's jitted drivers.

- ``device_cond`` takes and skips as its predicate says, returns the
  incoming state untouched when it skips, and raises ``TypeError`` (as
  ``lax.cond`` does) on a branch that changes the structure, a leaf's
  shape or dtype, or a static leaf. Its IF node's plain version
  (``_select``: the branch always runs, each replaced leaf
  ``torch.where(pred, out, in)``) runs here on CPU tensors: with the
  predicate false the result is the
  incoming state bit for bit, with it true the branch's result, and
  either way every replaced leaf is a fresh tensor and no incoming or
  outside tensor is written (values and ``data_ptr`` checks), views and
  expanded tensors included, on object motion's resample + MH branch, the
  SV filter's resample + move-reweight branch and tempered SMC's
  resample + two MH sweeps.
- The IF node's body logic (``_if_form``) runs here on a stand-in node:
  the THEN body as a capture records it, then, for a false predicate,
  the buffers poisoned and the ELSE body alone, as a replay runs it. On
  the same three branches and both predicates the result is bit-equal
  to ``_select``'s, no incoming tensor is written, the leaves the branch
  kept are the incoming objects and the others fresh buffers; a changed
  structure, shape, dtype or static leaf raises ``TypeError`` there too.
  ``device_cond`` takes the IF form under a capture, the select under
  ``_select_form`` (restored on exit and on error) and in the warm-up,
  and refuses a capture that ``capture`` did not make;
  ``ops/graph_cond.py`` raises on a CPU tensor, with no fallback.
- ``run_particle_filter`` (the SV model with move-reweight),
  ``tempered_smc`` (``run_tempered_smc``) and ``object_motion_filter_impl``
  are bit-equal, leaf for leaf, to a copy of the host-``if`` loop they had
  before, from one generator seed, at ess_frac 0 (never), 0.5 and 1.5
  (always); so is ``run_tempered_smc`` at each ``ess_frac``.
- Their LMLs over 4 seeds meet the JAX package's jitted drivers
  (``object_motion_filter``, ``sv_particle_filter`` through
  ``run_particle_filter``, ``run_tempered_smc`` through ``tempered_smc``),
  JAX run as its own suite runs it on the CPU. Tolerances: the mean LMLs
  within 6·(combined stderr) + 0.05 for object motion and SV (the gate of
  tests/test_torch_stochastic_volatility.py:95), and within 0.1 for
  tempered SMC, each side also within 0.1 of the quadrature log Z (the
  gate of tests/test_torch_tempered.py:72).
- ``capture`` refuses a CPU generator, ``mesh=`` and a model that is not
  ``batch_safe``; a ``CapturedRun`` copies new tensors into its static
  inputs, refuses a changed static argument, and returns fresh clones
  with shared leaves still shared.
- ``obs_at_t`` and ``lg_obs_at_t`` are bit-equal to JAX's, the mask on
  the device of the observations.
"""

import importlib
import math
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402

import genparticlefilters_tpu as jg  # noqa: E402
from genparticlefilters_tpu.models import linear_gaussian as jlg  # noqa
from genparticlefilters_tpu.models import object_motion as jom  # noqa: E402
from genparticlefilters_tpu.models import stochastic_volatility as jsv  # noqa
from genparticlefilters_tpu.models import tempered as jtm  # noqa: E402
import genparticlefilters_tpu_torch as tg  # noqa: E402
from genparticlefilters_tpu_torch.core.tree import (  # noqa: E402
    tree_flatten, tree_unflatten)
from genparticlefilters_tpu_torch.models import (  # noqa: E402
    linear_gaussian as tlg, object_motion as tom, stochastic_volatility as tsv,
    tempered as ttm)
from genparticlefilters_tpu_torch.core import packed as P  # noqa: E402
from genparticlefilters_tpu_torch.ops import graph_cond  # noqa: E402
from genparticlefilters_tpu_torch.smc.algorithms import (  # noqa: E402
    _resample_rejuvenate, run_particle_filter, tempered_smc)

# the module (the package's ``capture`` attribute is the function)
cap = importlib.import_module("genparticlefilters_tpu_torch.smc.capture")

T_OM, T_SV = 8, 12
ESS_FRACS = (0.0, 0.5, 1.5)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _assert_bit_equal(a, b):
    """Leaf for leaf: tensors bit-equal with one dtype, static leaves
    equal (two runs build two model objects, so the structures are
    compared by their leaves)."""
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i}"
        else:
            assert x == y, f"leaf {i}"


def _om_state(n=64, seed=0):
    y, _ = tom.synthesize_data(_gen(42), T_OM, 3)
    return tom.object_motion_filter(_gen(seed), y, n, T_OM), y


def _snapshot(state):
    leaves, _ = tree_flatten(state)
    return [(x, x.clone()) for x in leaves if isinstance(x, torch.Tensor)]


def _unwritten(snap):
    for x, before in snap:
        assert torch.equal(x, before)


# ---------------------------------------------------------------------------
# device_cond
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("take", [True, False])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_device_cond_takes_and_skips(take, as_tensor):
    state, _ = _om_state()
    snap = _snapshot(state)
    calls = []

    def branch(s):
        calls.append(1)
        return tg.pf_resample(_gen(5), s, "systematic", check=False)
    pred = torch.tensor(take) if as_tensor else take
    out = tg.device_cond(pred, branch, state)
    assert len(calls) == int(take)
    if take:
        _assert_bit_equal(out, tg.pf_resample(_gen(5), state, "systematic",
                                              check=False))
        in_ptrs = {x.data_ptr() for x, _ in snap}
        replaced = [o for o, x in zip(tree_flatten(out)[0],
                                      tree_flatten(state)[0])
                    if isinstance(o, torch.Tensor) and o is not x]
        assert replaced and not any(o.data_ptr() in in_ptrs
                                    for o in replaced)
    else:
        assert out is state
    _unwritten(snap)


def test_host_pred_reads_a_cpu_predicate():
    assert tg.host_pred(torch.tensor(True)) is True
    assert tg.host_pred(torch.tensor(1.0) < 0.5) is False


def _bad_branches():
    def structure(s):
        return s.replace(traces=(s.traces,))

    def shape(s):
        return s.replace(log_weights=s.log_weights[:-1])

    def dtype(s):
        return s.replace(log_weights=s.log_weights.double())

    def static(s):
        tr = s.traces
        inner = dict(tr.inner, t=tr.inner["t"] + 1)
        return s.replace(traces=type(tr)(tr.gen_fn, tr.args, tr.retval,
                                         tr.score, inner))
    return {"structure": structure, "shape": shape, "dtype": dtype,
            "static": static}


@pytest.mark.parametrize("kind", sorted(_bad_branches()))
def test_device_cond_raises_on_a_changed_state(kind):
    state, _ = _om_state()
    branch = _bad_branches()[kind]
    with pytest.raises(TypeError, match="device_cond"):
        tg.device_cond(torch.tensor(True), branch, state)
    # the captured form checks the same
    with pytest.raises(TypeError, match="device_cond"):
        cap._select(torch.tensor(False), branch, state)


def _fresh_leaves(out, *inputs):
    """Every tensor leaf of ``out`` that is not an input leaf shares no
    storage with any tensor of ``inputs``."""
    given = [x for x in tree_flatten(inputs)[0] if isinstance(x, torch.Tensor)]
    ptrs = {x.untyped_storage().data_ptr() for x in given}
    ids = {id(x) for x in given}
    replaced = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor) and id(o) not in ids]
    assert replaced
    assert not any(o.untyped_storage().data_ptr() in ptrs for o in replaced)


@pytest.mark.parametrize("take", [False, True])
@pytest.mark.parametrize("method", ["systematic", "residual"])
def test_captured_form_selects_on_the_device(method, take):
    """The captured form on CPU tensors: the branch always runs; the
    result is the incoming state (predicate false) or the branch's result
    (true), bit for bit, in fresh tensors, and no incoming tensor is
    written."""
    state, y = _om_state()
    snap = _snapshot(state)
    steps = torch.arange(T_OM)

    def branch(s):
        s = tg.pf_resample(_gen(7), s, method, check=False)
        sel = tg.Selection({("moving",): steps == 4, ("y",): steps == 4})
        return tg.pf_rejuvenate(_gen(8), s, tg.mh, (sel,), window=2)
    out = cap._select(torch.tensor(take), branch, state)
    _unwritten(snap)
    _fresh_leaves(out, state)
    _assert_bit_equal(out, branch(state) if take else state)


@pytest.mark.parametrize("take", [False, True])
def test_captured_form_writes_no_view_or_outside_tensor(take):
    """A branch returning a view of an incoming leaf, an expanded tensor
    and a tensor from outside it: the selected leaves are fresh, and the
    incoming state and the outside tensor keep their values."""
    state = (torch.arange(6.0).reshape(2, 3), torch.ones(3), torch.zeros(3),
             torch.zeros(3))
    outside = torch.full((3,), 7.0)

    def branch(s):
        return (s[0][:, :], torch.zeros(()).expand(3), outside, s[3] + 1)
    before = [x.clone() for x in state + (outside,)]
    out = cap._select(torch.tensor(take), branch, state)
    for x, x0 in zip(state + (outside,), before):
        assert torch.equal(x, x0)
    _fresh_leaves(out, state, outside)
    want = branch(state) if take else state
    for o, w in zip(out, want):
        assert torch.equal(o, w)


# ---------------------------------------------------------------------------
# The filter loops against a copy of their host-if loops
# ---------------------------------------------------------------------------

def _host_if_run_particle_filter(gen, model, t_max, n_particles, step_args_fn,
                                 obs_fn, ess_frac, resample_method,
                                 rejuvenate_fn):
    """run_particle_filter's loop as it was: a Python ``if`` on the host
    read of the ESS."""
    state = tg.pf_initialize(gen, model, step_args_fn(0), obs_fn(0),
                             n_particles)
    diffs = (tg.Extend(1),) + tuple(
        tg.NoChange() for _ in range(len(step_args_fn(0)) - 1))
    for t in range(1, t_max):
        if bool(tg.effective_sample_size(state) < ess_frac * n_particles):
            state = tg.pf_resample(gen, state, resample_method, check=False)
            if rejuvenate_fn is not None:
                state = rejuvenate_fn(gen, state, t)
        state = tg.pf_update(gen, state, step_args_fn(t), diffs, obs_fn(t),
                             check=False)
    return state


def _host_if_tempered_smc(gen, model, betas, n_particles, rejuvenate_fn,
                          ess_frac):
    """tempered_smc's loop as it was."""
    state = tg.pf_initialize(gen, model, (betas[0],), tg.EMPTY, n_particles)
    for i in range(1, betas.shape[0]):
        if bool(tg.effective_sample_size(state) < ess_frac * n_particles):
            state = tg.pf_resample(gen, state, "systematic", check=False)
            state = rejuvenate_fn(gen, state, betas[i])
        state = tg.pf_update(gen, state, (betas[i],), (tg.UnknownChange(),),
                             tg.EMPTY, check=False)
    return state, tg.log_ml_estimate(state)


def _host_if_object_motion_filter(gen, y_obs, n_particles, t_max, ess_frac,
                                  resample_method):
    """object_motion_filter's loop as it was."""
    model = tom.make_object_motion(t_max)
    x0 = tom.init_state("cpu")
    obs = tom.obs_dense(y_obs)
    state = tg.pf_initialize(gen, model, (1, x0), obs, n_particles)
    steps = torch.arange(t_max)
    for t in range(1, t_max):
        if bool(tg.effective_sample_size(state) < ess_frac * n_particles):
            state = tg.pf_resample(gen, state, resample_method, check=False)
            sel_mask = (steps == t - 1) | (steps == t)
            sel = tg.Selection({("moving",): sel_mask, ("y",): sel_mask})
            state = tg.pf_rejuvenate(gen, state, tg.mh, (sel,), window=2)
        state = tg.pf_update(gen, state, (t + 1, x0),
                             (tg.Extend(1), tg.NoChange()), obs, check=False)
    return state


def _sv_parts(y):
    p = tsv.SVParams()
    model = tsv.make_sv_model(T_SV, p)
    h0 = torch.full((), p.mu)
    steps = torch.arange(T_SV)
    obs = tsv.sv_obs_dense(y)

    def rejuvenate(gen_, state, t):
        sel = tg.Selection({("h",): steps == (t - 1)})
        return tg.pf_move_reweight(gen_, state, tg.move_reweight, (sel,),
                                   window=2)
    return model, (lambda t: (t + 1, h0)), (lambda t: obs), rejuvenate


@pytest.mark.parametrize("ess_frac", ESS_FRACS)
def test_run_particle_filter_matches_the_host_if_loop(ess_frac):
    y = tsv.synthesize_sv_data(_gen(1), T_SV, tsv.SVParams())
    model, args_fn, obs_fn, rejuv = _sv_parts(y)
    got = run_particle_filter(_gen(3), model, T_SV, 256, args_fn, obs_fn,
                              ess_frac=ess_frac, resample_method="systematic",
                              rejuvenate_fn=rejuv)
    want = _host_if_run_particle_filter(_gen(3), model, T_SV, 256, args_fn,
                                        obs_fn, ess_frac, "systematic", rejuv)
    _assert_bit_equal(got, want)


def _tm_rejuv(gen_, state, beta):
    return tg.pf_rejuvenate(gen_, state, tg.mh, (tg.select("x"),), n_iters=2)


@pytest.mark.parametrize("ess_frac", ESS_FRACS)
def test_tempered_smc_matches_the_host_if_loop(ess_frac):
    model = ttm.make_tempered_model()
    betas = torch.linspace(0.0, 1.0, 12) ** 2
    got = tempered_smc(_gen(4), model, betas, 256, rejuvenate_fn=_tm_rejuv,
                       ess_frac=ess_frac)
    want = _host_if_tempered_smc(_gen(4), model, betas, 256, _tm_rejuv,
                                 ess_frac)
    _assert_bit_equal(got, want)
    # run_tempered_smc is the same loop at its ess_frac
    _assert_bit_equal(ttm.run_tempered_smc(_gen(4), 256, 12, 2,
                                           ess_frac=ess_frac), want)


@pytest.mark.parametrize("method", ["residual", "systematic"])
@pytest.mark.parametrize("ess_frac", ESS_FRACS)
def test_object_motion_filter_impl_matches_the_host_if_loop(ess_frac,
                                                            method):
    y, _ = tom.synthesize_data(_gen(42), T_OM, 3)
    got = tom.object_motion_filter_impl(_gen(6), y, 256, T_OM, ess_frac,
                                        method)
    want = _host_if_object_motion_filter(_gen(6), y, 256, T_OM, ess_frac,
                                         method)
    _assert_bit_equal(got, want)
    # the eager entry point is the same run
    _assert_bit_equal(tom.object_motion_filter(_gen(6), y, 256, T_OM,
                                               ess_frac, method), got)


def test_the_driver_spans_are_kept():
    """Eager, each step still opens ``om.ess_check`` (which holds the host
    read) and, where the branch fires, ``om.resample`` and
    ``om.rejuvenate``: the profiled runs' phase breakdowns keep their
    meaning."""
    y, _ = tom.synthesize_data(_gen(42), T_OM, 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tom.object_motion_filter_impl(_gen(6), y, 64, T_OM, ess_frac=1.5)
    counts = {e.key: e.count for e in prof.key_averages()}
    for name in ("om.ess_check", "om.resample", "om.rejuvenate",
                 "om.update"):
        assert counts[name] == T_OM - 1, (name, counts.get(name))


def _sv_branch_case():
    """A filtered SV state and the branch run_particle_filter hands to
    device_cond at its last step: systematic resampling, then
    move-reweight on h at the step before (window 2)."""
    y = tsv.synthesize_sv_data(_gen(1), T_SV, tsv.SVParams())
    model, args_fn, obs_fn, rejuv = _sv_parts(y)
    state = run_particle_filter(_gen(2), model, T_SV, 64, args_fn, obs_fn,
                                ess_frac=0.5, resample_method="systematic",
                                rejuvenate_fn=rejuv)
    return state, lambda s: _resample_rejuvenate(
        _gen(7), s, "systematic", rejuv, T_SV - 1, "sv")


def _tempered_branch_case():
    """A tempered state and the branch tempered_smc hands to device_cond:
    systematic resampling, then two MH sweeps on x."""
    betas = torch.linspace(0.0, 1.0, 12) ** 2
    state, _ = tempered_smc(_gen(4), ttm.make_tempered_model(), betas, 64,
                            rejuvenate_fn=_tm_rejuv, ess_frac=0.5)
    return state, lambda s: _resample_rejuvenate(
        _gen(8), s, "systematic", _tm_rejuv, betas[-1], "tm")


@pytest.mark.parametrize("take", [False, True])
@pytest.mark.parametrize("case", ["sv", "tempered"])
def test_captured_form_selects_the_sv_and_tempered_branches(case, take):
    """The captured form of the SV filter's move-reweight branch and of
    tempered SMC's MH branch: the incoming state (predicate false) or the
    branch's result (true), bit for bit, in fresh tensors, no incoming
    tensor written."""
    state, branch = {"sv": _sv_branch_case,
                     "tempered": _tempered_branch_case}[case]()
    snap = _snapshot(state)
    out = cap._select(torch.tensor(take), branch, state)
    _unwritten(snap)
    _fresh_leaves(out, state)
    _assert_bit_equal(out, branch(state) if take else state)


# ---------------------------------------------------------------------------
# The IF node's bodies (_if_form) on a stand-in node
# ---------------------------------------------------------------------------

class _StandInNode:
    """The card's IF node on the CPU, captured and replayed once with the
    predicate ``take``: ``then`` runs the THEN body's work as a capture
    records it, its copies only where ``take`` holds (and, where it does
    not, with ``gen``'s state restored after it: an untaken branch draws
    nothing); ``otherwise`` keeps the ELSE body and, where ``take`` does not
    hold, runs it after poisoning the buffers, so it must write every
    buffer itself. ``dsts`` lists each copy's destinations."""

    def __init__(self, bodies=2, take=True, gen=None):
        self.graphs = (None,) * bodies
        self.take, self.gen = take, gen
        self.buffers, self.dsts, self.else_body = [], [], None
        self.donated = self.buffered = 0
        self._copying = True

    def alloc(self, x):
        buf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        self.buffers.append(buf)
        return buf

    def copy(self, dsts, srcs):
        self.dsts.append(list(dsts))
        if self._copying:
            graph_cond.copy_leaves_plain(dsts, srcs)

    def then(self, fn):
        if self.take:
            return fn()
        drawn = self.gen.get_state() if self.gen is not None else None
        self._copying = False
        try:
            fn()
        finally:
            self._copying = True
            if drawn is not None:
                self.gen.set_state(drawn)

    def otherwise(self, fn):
        assert len(self.graphs) == 2, "an ELSE body on a one-body node"
        self.else_body = fn
        if not self.take:
            for buf in self.buffers:
                _poison(buf)
            fn()


def _poison(buf):
    """Overwrite every element of ``buf`` with a value it did not hold."""
    if buf.dtype == torch.bool:
        buf.logical_not_()
    elif buf.is_floating_point():
        buf.fill_(float("nan"))
    else:
        buf.bitwise_not_()


def _if_eager(take, branch, state, inputs=None):
    """``_if_form`` on a stand-in node, replayed once with predicate
    ``take``; ``inputs``: ``None``, no donation; a set of storage
    addresses, donation with those registered as a capture's static
    inputs (``core/packed.py`` ``static_inputs``)."""
    nodes = []

    def new_node(bodies):
        nodes.append(_StandInNode(bodies, take))
        return nodes[-1]
    with P.static_inputs(inputs or ()):
        out = cap._if_form(new_node, branch, state, inputs is not None)
    return out, nodes[0]


def _om_branch_case(method):
    state, _ = _om_state()
    steps = torch.arange(T_OM)

    def branch(s):
        s = tg.pf_resample(_gen(7), s, method, check=False)
        sel = tg.Selection({("moving",): steps == 4, ("y",): steps == 4})
        return tg.pf_rejuvenate(_gen(8), s, tg.mh, (sel,), window=2)
    return state, branch


_BRANCH_CASES = {"om systematic": lambda: _om_branch_case("systematic"),
                 "om residual": lambda: _om_branch_case("residual"),
                 "sv": _sv_branch_case, "tempered": _tempered_branch_case}


@pytest.mark.parametrize("take", [False, True])
@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_if_form_matches_the_select_form(case, take):
    """Object motion's, the SV filter's and tempered SMC's branches: the
    IF node's bodies give ``_select``'s result bit for bit, write no
    incoming tensor, keep the leaves the branch kept as the incoming
    objects and put every other in a fresh buffer of its own."""
    state, branch = _BRANCH_CASES[case]()
    snap = _snapshot(state)
    want = cap._select(torch.tensor(take), branch, state)
    out, node = _if_eager(take, branch, state)
    _unwritten(snap)
    _assert_bit_equal(out, want)
    in_leaves = tree_flatten(state)[0]
    kept = [o is x for x, o in zip(in_leaves, tree_flatten(branch(state))[0])]
    out_leaves = tree_flatten(out)[0]
    assert any(kept) and not all(kept)
    bufs = {id(b) for b in node.buffers}
    for x, o, k in zip(in_leaves, out_leaves, kept):
        if k:
            assert o is x
        elif isinstance(o, torch.Tensor):
            assert id(o) in bufs
    assert len(bufs) == sum(isinstance(o, torch.Tensor) and not k
                            for o, k in zip(out_leaves, kept))
    _fresh_leaves(out, state)


@pytest.mark.parametrize("kind", sorted(_bad_branches()))
def test_if_form_raises_on_a_changed_state(kind):
    state, _ = _om_state()
    with pytest.raises(TypeError, match="device_cond"):
        _if_eager(False, _bad_branches()[kind], state)


def _storages(*trees):
    return frozenset(x.untyped_storage().data_ptr()
                     for x in tree_flatten(trees)[0]
                     if isinstance(x, torch.Tensor))


@pytest.mark.parametrize("take", [False, True])
@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_donated_form_matches_the_select_form(case, take):
    """With donation the IF node's bodies give ``_select``'s result bit for
    bit on all four branches; every replaced leaf that no other leaf
    shares is written back into the incoming tensor (the result holds that
    very object), the others go to buffers; the node has an ELSE body
    only where some leaf cannot be donated, and each body copies once."""
    state, branch = _BRANCH_CASES[case]()
    want = cap._select(torch.tensor(take), branch, state)
    in_leaves = tree_flatten(state)[0]
    kept = [o is x for x, o in zip(in_leaves, tree_flatten(branch(state))[0])]
    own = cap._donatable(in_leaves)
    out, node = _if_eager(take, branch, state, frozenset())
    _assert_bit_equal(out, want)
    replaced = [i for i, (x, k) in enumerate(zip(in_leaves, kept))
                if isinstance(x, torch.Tensor) and not k]
    donated = [i for i in replaced if i in own]
    assert donated and (node.donated, node.buffered) == (
        len(donated), len(replaced) - len(donated))
    for i, (x, o) in enumerate(zip(in_leaves, tree_flatten(out)[0])):
        if kept[i] or i in own:
            assert o is x, f"leaf {i}"
        else:
            assert any(o is b for b in node.buffers), f"leaf {i}"
    tensors = [i for i, x in enumerate(in_leaves)
               if isinstance(x, torch.Tensor)]
    one_body = all(i in own for i in tensors)
    assert len(node.graphs) == (1 if one_body else 2)
    assert (node.else_body is None) == one_body
    assert [len(d) for d in node.dsts] == [len(replaced)] + (
        [] if one_body or take else [node.buffered])
    # object motion and SV donate every leaf; tempered SMC's state holds
    # one tensor as two leaves (x and the retval), which are buffered
    assert one_body == (case != "tempered")


@pytest.mark.parametrize("take", [False, True])
@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_donated_replay_writes_only_donated_leaves(case, take):
    """An untaken replay writes no incoming tensor; a taken one writes the
    donated leaves and the node's buffers and nothing else: every copy
    goes to one of those, and every other incoming tensor keeps its
    values."""
    state, branch = _BRANCH_CASES[case]()
    in_leaves = tree_flatten(state)[0]
    own = cap._donatable(in_leaves)
    snap = _snapshot(state)
    out, node = _if_eager(take, branch, state, frozenset())
    mine = {id(in_leaves[i]) for i in own} | {id(b) for b in node.buffers}
    assert all(id(d) in mine for dsts in node.dsts for d in dsts)
    for i, x in enumerate(in_leaves):
        if not isinstance(x, torch.Tensor):
            continue
        before = next(b for y, b in snap if y is x)
        if take and i in own and tree_flatten(out)[0][i] is x and not (
                torch.equal(x, before)):
            continue                    # a donated leaf, rewritten
        assert torch.equal(x, before), f"leaf {i} written"


def test_shared_and_registered_leaves_are_buffered():
    """A leaf whose storage another leaf shares, one whose storage is a
    registered input, a part of a larger storage and a strided leaf are
    buffered (the node gets an ELSE body); a leaf of its own is donated;
    taken and untaken, the result is the select's."""
    big = torch.arange(10.0)
    shared = torch.ones(3)
    given = torch.full((3,), 2.0)
    own = torch.zeros(3)
    state = (own, shared, shared, given, big[:3], big[::3][:3])

    def branch(s):
        return tuple(x * 3 + 1 for x in s)
    with P.static_inputs(_storages(given)):
        assert cap._donatable(state) == {0}
    for take in (False, True):
        before = [x.clone() for x in state]
        want = cap._select(torch.tensor(take), branch, state)
        out, node = _if_eager(take, branch, state, _storages(given))
        for o, w in zip(out, want):
            assert torch.equal(o, w)
        assert len(node.graphs) == 2
        assert (node.donated, node.buffered) == (1, 5)
        assert out[0] is own and all(o is not x
                                     for o, x in zip(out[1:], state[1:]))
        assert torch.equal(big, torch.arange(10.0))
        assert torch.equal(given, torch.full((3,), 2.0))
        assert torch.equal(shared, torch.ones(3))
        if not take:
            for x, x0 in zip(state, before):
                assert torch.equal(x, x0)
    # no leaf to buffer: one body, and no ELSE
    out, node = _if_eager(True, branch, (torch.zeros(3), torch.ones(2)),
                          frozenset())
    assert len(node.graphs) == 1 and node.else_body is None
    assert [len(d) for d in node.dsts] == [2]


@pytest.mark.parametrize("take", [False, True])
def test_donated_form_writes_views_expands_and_outside_tensors_right(take):
    """A branch returning a view of an incoming leaf, an expanded tensor,
    a tensor from outside it and two incoming leaves swapped: the donated
    result is the branch's (taken) or the incoming state (untaken), and
    the outside tensor keeps its values."""
    state = (torch.arange(6.0).reshape(2, 3), torch.ones(3), torch.zeros(3),
             torch.zeros(3), torch.arange(3.0), torch.arange(3.0) + 10)
    outside = torch.full((3,), 7.0)

    def branch(s):
        return (s[0][:, :], torch.zeros(()).expand(3), outside, s[3] + 1,
                s[5], s[4])
    before = [x.clone() for x in state]
    want = branch(tuple(before))
    want = tuple(w.clone() for w in want)
    out, node = _if_eager(take, branch, state, frozenset())
    assert node.donated == 6 and len(node.graphs) == 1
    assert torch.equal(outside, torch.full((3,), 7.0))
    for o, x, w, x0 in zip(out, state, want, before):
        assert o is x
        assert torch.equal(o, w if take else x0)


def test_copy_leaves_plain_copies_and_the_wrapper_checks():
    """``copy_leaves_plain`` copies each pair and refuses pairs that do not
    match; ``copy_leaves`` refuses the same, a strided tensor, and a CPU or
    meta tensor, before anything is launched (the kernel runs only on the
    card)."""
    dsts = [torch.zeros(5), torch.zeros(2, 3, dtype=torch.int32),
            torch.zeros(0), torch.zeros((), dtype=torch.bool)]
    srcs = [torch.arange(5.0), torch.arange(6, dtype=torch.int32).reshape(
        2, 3), torch.zeros(0), torch.ones((), dtype=torch.bool)]
    graph_cond.copy_leaves_plain(dsts, srcs)
    for d, s in zip(dsts, srcs):
        assert torch.equal(d, s)
    before = graph_cond.copy_leaves.launches
    for fn in (graph_cond.copy_leaves_plain, graph_cond.copy_leaves):
        with pytest.raises(ValueError, match="copies"):
            fn([torch.zeros(3)], [torch.zeros(4)])
        with pytest.raises(ValueError, match="copies"):
            fn([torch.zeros(3)], [torch.zeros(3, dtype=torch.float64)])
        with pytest.raises(ValueError, match="destinations"):
            fn([torch.zeros(3)], [])
    with pytest.raises(ValueError, match="contiguous"):
        graph_cond.copy_leaves([torch.zeros(3)], [torch.zeros(6)[::2]])
    for device in ("cpu", "meta"):
        with pytest.raises(ValueError, match="on one card"):
            graph_cond.copy_leaves([torch.zeros(3, device=device)],
                                   [torch.ones(3, device=device)])
    graph_cond.copy_leaves([], [])
    assert graph_cond.copy_leaves.launches == before


def _donating_drivers():
    """(driver, kw): each driver that passes ``donate=True``, as its
    host-``if`` test runs it, and the storages a capture would register
    (its tensor arguments)."""
    y_sv = tsv.synthesize_sv_data(_gen(1), T_SV, tsv.SVParams())
    model, args_fn, obs_fn, rejuv = _sv_parts(y_sv)
    betas = torch.linspace(0.0, 1.0, 12) ** 2
    y_om, _ = tom.synthesize_data(_gen(42), T_OM, 3)

    def sv(gen_, ess_frac):
        return run_particle_filter(gen_, model, T_SV, 256, args_fn, obs_fn,
                                   ess_frac=ess_frac,
                                   resample_method="systematic",
                                   rejuvenate_fn=rejuv)

    def sv_host(gen_, ess_frac):
        return _host_if_run_particle_filter(gen_, model, T_SV, 256, args_fn,
                                            obs_fn, ess_frac, "systematic",
                                            rejuv)

    def tm(gen_, ess_frac):
        return tempered_smc(gen_, ttm.make_tempered_model(), betas, 256,
                            rejuvenate_fn=_tm_rejuv, ess_frac=ess_frac)

    def tm_host(gen_, ess_frac):
        return _host_if_tempered_smc(gen_, ttm.make_tempered_model(), betas,
                                     256, _tm_rejuv, ess_frac)

    def om(method):
        return (lambda gen_, ess_frac: tom.object_motion_filter_impl(
            gen_, y_om, 256, T_OM, ess_frac, method),
            lambda gen_, ess_frac: _host_if_object_motion_filter(
                gen_, y_om, 256, T_OM, ess_frac, method), _storages(y_om))
    return {"sv": (sv, sv_host, _storages(y_sv)),
            "tempered": (tm, tm_host, _storages(betas)),
            "om systematic": om("systematic"), "om residual": om("residual")}


@pytest.mark.parametrize("ess_frac", ESS_FRACS)
@pytest.mark.parametrize("driver", ["om residual", "om systematic", "sv",
                                    "tempered"])
def test_drivers_donate_like_their_host_if_loops(monkeypatch, driver,
                                                 ess_frac):
    """``run_particle_filter``, ``tempered_smc`` and
    ``object_motion_filter_impl`` with every ESS check an IF node that
    donates (a stand-in replayed with the check's predicate): bit-equal to
    their host-``if`` loops, so the state a check is given is dead after
    it; every node of object motion and SV has one body and donates every
    leaf its branch replaces."""
    run, host, inputs = _donating_drivers()[driver]
    want = host(_gen(3), ess_frac)
    gen = _gen(3)
    nodes = _as_if_capturing(monkeypatch, gen, inputs)
    _assert_bit_equal(run(gen, ess_frac), want)
    checks = {"sv": T_SV - 1, "tempered": 11}.get(driver, T_OM - 1)
    assert len(nodes) == checks
    assert any(n.take for n in nodes) == (ess_frac > 0)
    if driver != "tempered":
        assert all(len(n.graphs) == 1 and n.buffered == 0 for n in nodes)
    assert all(n.donated > 0 for n in nodes)


def test_buffered_form_ignores_donate(monkeypatch):
    """Under ``_buffered_form`` a donating ``device_cond`` buffers every
    replaced leaf behind an ELSE body, as without ``donate``; the form is
    restored on exit and on error; ``CapturedRun.forms`` counts both."""
    cases = [_om_branch_case("systematic") for _ in range(3)]
    want = cases[0][1](cases[0][0])
    nodes = _as_if_capturing(monkeypatch)
    _assert_bit_equal(tg.device_cond(torch.tensor(True), cases[0][1],
                                     cases[0][0]), want)
    with cap._buffered_form():
        _assert_bit_equal(tg.device_cond(torch.tensor(True), cases[1][1],
                                         cases[1][0], donate=True), want)
    with pytest.raises(ZeroDivisionError):
        with cap._buffered_form():
            1 / 0
    assert cap._BUFFERING == [0]
    _assert_bit_equal(tg.device_cond(torch.tensor(True), cases[2][1],
                                     cases[2][0], donate=True), want)
    assert [len(n.graphs) for n in nodes] == [2, 2, 1]
    assert [n.donated for n in nodes] == [0, 0, 8]
    assert nodes[0].buffered == nodes[1].buffered == 8
    run = cap.CapturedRun(len, _NoGraph(), ((), {}), (), 0.0, 0, 3,
                          types.SimpleNamespace(nodes=nodes))
    assert run.forms == {"else_nodes": 2, "donated": 8, "buffered": 16}


def _as_if_capturing(monkeypatch, gen=None, inputs=frozenset()):
    """``device_cond`` as under ``capture``: the captured form taken for
    a CPU predicate, each IF node a stand-in replayed with that predicate
    (``nodes`` lists them; ``gen`` the generator an untaken branch must
    leave as it was), ``inputs`` the capture's registered storages."""
    nodes = []

    def card_node(pred, bodies, n):
        nodes.append(_StandInNode(n, bool(pred), gen))
        return nodes[-1]
    monkeypatch.setattr(cap, "_graph_form", lambda pred: True)
    monkeypatch.setattr(cap, "_CardNode", card_node)
    monkeypatch.setattr(cap, "_BODIES", [types.SimpleNamespace()])
    monkeypatch.setattr(P, "_STATIC", [frozenset(inputs)])
    return nodes


def test_device_cond_takes_the_if_form_under_a_capture(monkeypatch):
    """Under a capture ``device_cond`` makes one IF node per call; under
    ``_select_form`` and in the warm-up it selects; both forms return the
    branch's result for a true predicate."""
    state, branch = _om_branch_case("systematic")
    nodes = _as_if_capturing(monkeypatch)
    want = branch(state)
    _assert_bit_equal(tg.device_cond(torch.tensor(True), branch, state), want)
    assert len(nodes) == 1
    with cap._select_form():
        _assert_bit_equal(tg.device_cond(torch.tensor(True), branch, state),
                          want)
    with cap._warming():
        tg.device_cond(torch.tensor(True), branch, state)
    assert len(nodes) == 1
    tg.device_cond(torch.tensor(True), branch, state)
    assert len(nodes) == 2


def test_select_form_is_restored_on_exit_and_on_error(monkeypatch):
    state, branch = _om_branch_case("systematic")
    nodes = _as_if_capturing(monkeypatch)
    with cap._select_form():
        with cap._select_form():
            tg.device_cond(torch.tensor(False), branch, state)
        tg.device_cond(torch.tensor(False), branch, state)
    assert cap._SELECTING == [0] and not nodes
    with pytest.raises(ZeroDivisionError):
        with cap._select_form():
            1 / 0
    assert cap._SELECTING == [0]
    tg.device_cond(torch.tensor(False), branch, state)
    assert len(nodes) == 1


def test_device_cond_refuses_a_capture_it_did_not_make(monkeypatch):
    state, branch = _om_branch_case("systematic")
    monkeypatch.setattr(cap, "_graph_form", lambda pred: True)
    with pytest.raises(RuntimeError, match="capture"):
        tg.device_cond(torch.tensor(True), branch, state)


def test_graph_cond_raises_on_a_cpu_tensor():
    """The shim reads its predicate on the card: a CPU or meta tensor, or a
    Python bool, raises before anything is built, and no node is
    counted."""
    before = graph_cond.if_node.launches
    for pred in (torch.tensor(True), torch.ones((), dtype=torch.bool,
                                                device="meta"), True):
        with pytest.raises(ValueError, match="on the card"):
            graph_cond.if_node(pred)
    for bodies in (0, 3):
        with pytest.raises(ValueError, match="1 or 2 bodies"):
            graph_cond.if_node(torch.tensor(True), bodies)
    assert graph_cond.if_node.launches == before
    assert graph_cond.CAPTURE_MODE == 0    # cudaStreamCaptureModeGlobal


# ---------------------------------------------------------------------------
# LMLs against the JAX package's jitted drivers
# ---------------------------------------------------------------------------

SEEDS = 4


def _mean_gate(tl, jl, extra=0.05):
    se = math.sqrt(np.var(jl) / SEEDS + np.var(tl) / SEEDS)
    assert abs(np.mean(tl) - np.mean(jl)) < 6 * se + extra, (tl, jl)


def test_object_motion_lml_meets_the_jitted_jax_filter():
    n = 4000
    y, _ = jom.synthesize_data(jr.key(42), T_OM, 3)
    jl = [float(jg.log_ml_estimate(jom.object_motion_filter(
        jr.key(10 + s), y, n, T_OM))) for s in range(SEEDS)]
    ty = torch.from_numpy(np.array(y))
    tl = [float(tg.log_ml_estimate(tom.object_motion_filter_impl(
        _gen(20 + s), ty, n, T_OM))) for s in range(SEEDS)]
    _mean_gate(tl, jl)


def test_sv_run_particle_filter_lml_meets_the_jitted_jax_filter():
    n, t_max = 4000, 20
    p = jsv.SVParams()
    y = np.array(jsv.synthesize_sv_data(jr.key(1), t_max, p))
    jf = jax.jit(jsv.sv_particle_filter, static_argnums=(2, 3, 6, 7))
    jl = [float(jg.log_ml_estimate(jf(jr.key(10 + s), jnp.asarray(y), n,
                                      t_max, p, 0.5, 1, 2)))
          for s in range(SEEDS)]
    tl = [float(tg.log_ml_estimate(tsv.sv_particle_filter(
        _gen(20 + s), torch.from_numpy(y), n, t_max, tsv.SVParams())))
        for s in range(SEEDS)]
    _mean_gate(tl, jl)


def test_tempered_smc_lml_meets_the_jitted_jax_driver():
    n = 4000
    jf = jax.jit(jtm.run_tempered_smc, static_argnums=(1, 2, 3))
    jl = [float(jf(jr.key(10 + s), n, 50, 2)[1]) for s in range(SEEDS)]
    tl = [float(ttm.run_tempered_smc(_gen(20 + s), n)[1])
          for s in range(SEEDS)]
    assert abs(np.mean(tl) - np.mean(jl)) < 0.1, (tl, jl)
    log_z = ttm.tempered_log_z()
    assert abs(np.mean(tl) - log_z) < 0.1 and abs(np.mean(jl) - log_z) < 0.1


# ---------------------------------------------------------------------------
# capture and CapturedRun
# ---------------------------------------------------------------------------

def test_capture_refuses_the_forms_that_run_uncaptured():
    y, _ = tom.synthesize_data(_gen(42), T_OM, 3)
    with pytest.raises(ValueError, match="generator on the card"):
        tom.object_motion_filter_captured(_gen(0), y, 64, T_OM)
    with pytest.raises(ValueError, match="generator on the card"):
        tg.capture(tom.object_motion_filter_impl, _gen(0), y, 64, T_OM)
    with pytest.raises(NotImplementedError, match="batch_safe"):
        tg.capture(tom.object_motion_filter_impl, _gen(0), y, 64, T_OM,
                   batch_safe=False)
    unmarked = tom.make_object_motion(T_OM, batch_safe=False)
    x0 = tom.init_state("cpu")
    obs = tom.obs_dense(y)
    with pytest.raises(NotImplementedError, match="batch_safe"):
        tg.capture(run_particle_filter, _gen(0), unmarked, T_OM, 64,
                   lambda t: (t + 1, x0), lambda t: obs)
    with pytest.raises(NotImplementedError, match="mesh"):
        tg.capture(run_particle_filter, _gen(0), tom.make_object_motion(T_OM),
                   T_OM, 64, lambda t: (t + 1, x0), lambda t: obs,
                   mesh=object())


class _NoGraph:
    """Stands in for a captured graph on the CPU: a replay does nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_run_loads_inputs_and_returns_fresh_clones():
    state, y = _om_state()
    static_y = y.clone()
    run = cap.CapturedRun(tom.object_motion_filter_impl, _NoGraph(),
                          ((static_y, 64, T_OM), {"ess_frac": 0.5}), state,
                          0.0, 0)
    out = run()
    assert run.graph.replays == 1
    _assert_bit_equal(out, state)
    old = {x.data_ptr() for x in tree_flatten(state)[0]
           if isinstance(x, torch.Tensor) and x.numel()}
    assert not any(x.data_ptr() in old for x in tree_flatten(out)[0]
                   if isinstance(x, torch.Tensor) and x.numel())
    y2 = y + 1.0
    run(y2.numpy(), 64, T_OM, ess_frac=0.5)
    assert torch.equal(static_y, y2) and run.graph.replays == 2
    run(y)          # the arguments not given keep their captured values
    assert torch.equal(static_y, y) and run.graph.replays == 3
    with pytest.raises(ValueError, match="changed"):
        run(y2, 64, T_OM, ess_frac=0.75)
    with pytest.raises(ValueError, match="changed"):
        run(y2, 65)
    with pytest.raises(ValueError, match="shape"):
        run(y2[:-1])
    with pytest.raises(ValueError, match="keywords"):
        run(y2, resample_method="systematic")
    with pytest.raises(ValueError, match="structure"):
        run((y2,))
    assert run.graph.replays == 3


def test_captured_run_keeps_shared_leaves_shared():
    a, b = torch.ones(3), torch.zeros(2)
    run = cap.CapturedRun(len, _NoGraph(), ((), {}), (a, a, b), 0.0, 0)
    out = run()
    assert out[0] is out[1] and out[0] is not a and out[2] is not b
    assert torch.equal(out[0], a) and torch.equal(out[2], b)


# ---------------------------------------------------------------------------
# The observation helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0, 3, 7])
def test_obs_at_t_matches_jax(t):
    y, _ = jom.synthesize_data(jr.key(42), T_OM, 3)
    je = jom.obs_at_t(y, t).entries[("y_obs",)]
    ty = torch.from_numpy(np.array(y))
    for tt in (t, torch.tensor(t)):
        te = tom.obs_at_t(ty, tt).entries[("y_obs",)]
        np.testing.assert_array_equal(te.value.numpy(), np.asarray(je.value))
        np.testing.assert_array_equal(te.mask.numpy(), np.asarray(je.mask))
        assert te.mask.dtype == torch.bool


@pytest.mark.parametrize("t", [0, 4, 9])
def test_lg_obs_at_t_matches_jax(t):
    p = jlg.LGParams()
    y = jlg.synthesize_lg_data(jr.key(3), 10, p)
    je = jlg.lg_obs_at_t(y, t).entries[("y",)]
    te = tlg.lg_obs_at_t(torch.from_numpy(np.array(y)), t).entries[("y",)]
    np.testing.assert_array_equal(te.value.numpy(), np.asarray(je.value))
    np.testing.assert_array_equal(te.mask.numpy(), np.asarray(je.mask))


def test_observation_masks_are_built_on_the_device_of_the_observations():
    y = torch.empty(6, device="meta")
    assert tom.obs_at_t(y, 2).entries[("y_obs",)].mask.device.type == "meta"
    assert tlg.lg_obs_at_t(y, 2).entries[("y",)].mask.device.type == "meta"
