"""The packed store's writer in place (core/packed.py ``write_steps``,
``owned``; ``Unfold.generate``; ``pf_update(donate=True)``; the drivers).

On the CPU: a donated write lands in the incoming storage with the bits
of the copy; a store that fails the whole-storage test (a view, a storage
two leaves share, a capture's static input) is copied and counted so;
the public ``pf_update`` leaves its input untouched; ``generate``'s
zero-filled empty store holds the bits of the old per-leaf zeros and
concatenation; the object-motion, SV, MOT and MOT-DA drivers give the
same final state bit for bit with donation and with every write forced
to copy (``packed.may_overwrite``, the one ownership rule, patched),
and count no copy of the update; the IF node and the store writer decide
alike where a tensor may be overwritten.

Marked ``chip``, on the card (the file imports no JAX: run it there with
``python -m pytest --noconftest tests/test_torch_store_donation.py -m
chip``): the captured object-motion 1M, SV 100K and MOT 1M filters
replay bit-equal to their eager runs and to copy-on-write captures from
one seed, count no store copy per replay, and run ``T`` fewer
``Memcpy DtoD`` a replay than the copy-on-write graph.
"""

import contextlib
import importlib

import pytest
import torch

import genparticlefilters_tpu_torch as tg
from genparticlefilters_tpu_torch.core import combinators as C
from genparticlefilters_tpu_torch.core import packed as P
from genparticlefilters_tpu_torch.core.gfi import (Extend, NoChange,
                                                   batched_interpretation)
from genparticlefilters_tpu_torch.core.tree import (tree_flatten, tree_map,
                                                    tree_unflatten)
from genparticlefilters_tpu_torch.models import multi_object as mo
from genparticlefilters_tpu_torch.models import object_motion as om
from genparticlefilters_tpu_torch.models import stochastic_volatility as sv

# the module (the package's ``smc.capture`` attribute is the function)
cap = importlib.import_module("genparticlefilters_tpu_torch.smc.capture")

T = 6


@pytest.fixture
def card():
    """The card, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda")


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(a, b):
    """Leaf for leaf: tensors of one dtype and shape, bit-equal; other
    leaves equal."""
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f"leaf {i}"
            assert torch.equal(_bits(x).cpu(), _bits(y).cpu()), f"leaf {i}"
        else:
            assert x == y, f"leaf {i}"


def _snapshot(tree):
    return [(x, x.clone()) for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor)]


def _untouched(snap):
    return all(torch.equal(_bits(x), _bits(c)) for x, c in snap)


@contextlib.contextmanager
def _writes():
    """The ``STORE_WRITES`` made inside, as a dict filled on exit."""
    before = dict(P.STORE_WRITES)
    got = {}
    yield got
    got.update({k: P.STORE_WRITES[k] - v for k, v in before.items()})


# --- write_steps ------------------------------------------------------------

def _tree(n, g):
    """A stacked tree of every packed kind (float32 [K, 2], int32, bool),
    a shared float32 extra, a float64 per-particle extra, a zero-width
    leaf and a static column; ``n`` None: the per-particle form."""
    tn = (T,) if n is None else (T, n)
    return ({"x": torch.randn(tn + (3, 2), generator=g),
             "i": torch.randint(0, 100, tn, dtype=torch.int32, generator=g),
             "b": torch.rand(tn, generator=g) < 0.5,
             "shared": torch.randn(T, 3, generator=g),
             "f64": torch.randn(tn, generator=g, dtype=torch.float64),
             "z": torch.zeros(tn + (0,)),
             "len": P.StaticColumn(range(T))},
            {"x": 1, "i": 1, "b": 1, "shared": None, "f64": 1, "z": 1,
             "len": None})


def _cols(st, n, g, k):
    cols = []
    for j in range(k):
        c = P.zeros_column(st)
        c["x"] = torch.randn(n, 3, 2, generator=g)
        c["i"] = torch.randint(0, 100, (n,), dtype=torch.int32, generator=g)
        c["b"] = torch.rand(n, generator=g) < 0.5
        c["shared"] = torch.randn(3, generator=g)
        c["f64"] = torch.randn(n, generator=g, dtype=torch.float64)
        c["len"] = 7 + j
        cols.append(c)
    return cols


@pytest.mark.parametrize("k", [1, 2])
def test_a_donated_write_lands_in_the_incoming_storage(k):
    g = _gen(0)
    n = 9
    tree, spec = _tree(n, g)
    st = P.make_storage(tree, spec, T)
    cols = _cols(st, n, g, k)
    copy = P.write_steps(st, 2, cols)
    assert P.storage_of(copy.mat) != P.storage_of(st.mat)
    ptr = st.mat.data_ptr()
    with P.owned([P.storage_of(st.mat)]), _writes() as w:
        got = P.write_steps(st, 2, cols)
    assert w == {"copied": 0, "in_place": 1}
    assert got.mat is st.mat and got.mat.data_ptr() == ptr
    _assert_same(P.unpack_tree(got), P.unpack_tree(copy))


def test_a_copied_store_of_any_strides_is_written_whole():
    """A store whose ``mat`` is not row-major (here the transpose of a
    contiguous tensor) is copied into a contiguous one and written."""
    g = _gen(6)
    n = 7
    tree, spec = _tree(n, g)
    st = P.make_storage(tree, spec, T)
    cols = _cols(st, n, g, 1)
    want = P.write_steps(st, 3, cols)
    st_t = P.StepStorage(st.mat.t().contiguous().t(), st.extras, st.layout)
    assert not st_t.mat.is_contiguous()
    with P.owned([P.storage_of(st_t.mat)]), _writes() as w:
        got = P.write_steps(st_t, 3, cols)
    assert w == {"copied": 1, "in_place": 0}
    assert got.mat.is_contiguous()
    _assert_same(P.unpack_tree(got), P.unpack_tree(want))


def test_a_rescan_reading_its_own_rows_writes_the_same_bits():
    """A column that holds views of the rows being written (a re-scan
    keeping old values) is read before any row is written."""
    g = _gen(1)
    n = 5
    tree, spec = _tree(n, g)
    st = P.make_storage(tree, spec, T)
    cols = [P.read_step(st, t) for t in (3, 2, 1, 0)]   # views of mat
    copy = P.write_steps(st, 0, cols)
    with P.owned([P.storage_of(st.mat)]):
        got = P.write_steps(st, 0, cols)
    assert got.mat is st.mat
    _assert_same(P.unpack_tree(got), P.unpack_tree(copy))


def test_per_particle_form_writes_out_of_place_uncounted():
    g = _gen(2)
    tree, _ = _tree(None, g)
    st = P.make_storage({"i": tree["i"], "b": tree["b"]}, {"i": 1, "b": 1},
                        T, batched=False)
    col = {"i": torch.tensor(4, dtype=torch.int32), "b": torch.tensor(True)}
    with P.owned([P.storage_of(st.mat)]), _writes() as w:
        got = P.write_steps(st, 1, [col])
    assert w == {"copied": 0, "in_place": 0}
    assert P.storage_of(got.mat) != P.storage_of(st.mat)


# --- one rule for the IF node and the store writer -------------------------

def _rule_case(case):
    """``(store, donating tree, static inputs, column)`` for ``case``, a
    store of one int32 row per step; "empty" holds no particle."""
    g = _gen(13)
    st = P.make_storage({"i": torch.randint(0, 9, (T, 6), dtype=torch.int32,
                                            generator=g)}, {"i": 1}, T)
    n = 0 if case == "empty" else 6
    if case == "empty":
        st = P.StepStorage(torch.empty((T, 0), dtype=torch.int32), (),
                           st.layout)
    elif case == "view":
        big = torch.cat([st.mat, st.mat[:1]])
        st = P.StepStorage(big[:T], st.extras, st.layout)
    holder = {"store": st, "w": torch.zeros(n)}
    if case == "shared":
        holder["parents"] = st.mat[0]
    static = [P.storage_of(st.mat)] if case == "static" else []
    col = {"i": torch.randint(0, 9, (n,), dtype=torch.int32, generator=g)}
    return st, holder, static, col


@pytest.mark.parametrize("case,want", [
    ("alone", (True, True)), ("held once", (True, True)),
    ("view", (False, False)), ("shared", (False, False)),
    ("static", (False, False)), ("empty", (True, False))])
def test_the_if_node_and_the_writer_decide_alike(case, want):
    """``(IF node donates mat, writer writes mat in place)``: one rule
    (``packed.may_overwrite``) for both, on a whole unshared ``mat`` (alone
    on its storage, and held once by the tree with a view outside it), a
    view, a storage another leaf shares, a registered static input; an
    empty ``mat`` keeps each caller's answer (donated; copied)."""
    st, holder, static, col = _rule_case(case)
    outside = st.mat[:1] if case == "held once" else None
    if case in ("alone", "held once"):
        assert P._alone(st.mat) == (outside is None)
    leaves = tree_flatten(holder)[0]
    i = next(i for i, x in enumerate(leaves) if x is st.mat)
    with P.static_inputs(static):
        donated = i in cap._donatable(leaves)
        with P.owned([P.storage_of(st.mat)], holder), _writes() as w:
            got = P.write_steps(st, 2, [col])
    assert (donated, w["in_place"] == 1) == want
    assert w["in_place"] + w["copied"] == 1
    assert (got.mat is st.mat) == want[1]


# --- generate's empty store ---------------------------------------------------

def _old_empty(col, spec, T, batched=True):
    """The parent's empty store: per-leaf zeros ``[T, ...]``
    concatenated."""
    return P.make_storage(tree_map(
        lambda l: (P.StaticColumn([type(l)(0)] * T)
                   if isinstance(l, (bool, int, float))
                   else torch.zeros((T,) + tuple(l.shape), dtype=l.dtype,
                                    device=l.device)), col),
        spec, T, batched=batched)


@pytest.mark.parametrize("batched", [True, False])
def test_the_zero_filled_store_is_the_concatenated_one(batched):
    g = _gen(3)
    tree, spec = _tree(4 if batched else None, g)
    col = {k: (torch.zeros(v.shape[1:], dtype=v.dtype)
               if isinstance(v, torch.Tensor) else 0)
           for k, v in tree.items()}
    old = _old_empty(col, spec, T, batched)
    new = P.zeros_storage(col, spec, T, batched)
    assert new.layout == old.layout
    assert new.mat.shape == old.mat.shape and new.mat.is_contiguous()
    _assert_same((new.mat, new.extras), (old.mat, old.extras))
    assert all(e.is_contiguous() for e in new.extras
               if isinstance(e, torch.Tensor))


def test_a_built_store_is_a_tensor_of_its_own():
    """``make_storage``'s batched ``mat`` is no view, so that a writer
    may own it; its bits are the concatenated rows'."""
    g = _gen(12)
    n = 4
    tree, spec = _tree(n, g)
    st = P.make_storage(tree, spec, T)
    assert st.mat._base is None and P.is_whole(st.mat)
    _assert_same(P.unpack_tree(st), tree)


def _old_writer(monkeypatch):
    """The parent's writer: every store copied, the empty store built
    from per-leaf zeros by concatenation."""
    monkeypatch.setattr(P, "may_overwrite", lambda x, holder=None: False)
    monkeypatch.setattr(C, "zeros_storage", _old_empty)


_MODELS = {
    "om": lambda: (om.make_object_motion(T), (T, om.init_state("cpu")),
                   tg.EMPTY),
    "mot_da": lambda: (mo.make_mot_da_model(T, mo.MOTParams()),
                       (T, mo._x0(mo.MOTParams(), "cpu")), tg.EMPTY),
    "mot_obs": lambda: (mo.make_mot_model(T, mo.MOTParams()),
                        (T, mo._x0(mo.MOTParams(), "cpu")),
                        mo.mot_obs_dense(torch.randn(T, 4, 2,
                                                     generator=_gen(9)))),
}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_generate_gives_the_old_traces_in_place(name, monkeypatch):
    model, args, obs = _MODELS[name]()
    with batched_interpretation(33), _writes() as w:
        new, wn = model.generate(_gen(4), args, obs)
    assert w == {"copied": 0, "in_place": 1}
    with monkeypatch.context() as mp:
        _old_writer(mp)
        with batched_interpretation(33), _writes() as w:
            old, wo = model.generate(_gen(4), args, obs)
    assert w == {"copied": 1, "in_place": 0}
    _assert_same((new, wn), (old, wo))


# --- pf_update ------------------------------------------------------------------

def _om_state(n=40, seed=5):
    y, _ = om.synthesize_data(_gen(42), T, 3)
    model = om.make_object_motion(T)
    x0 = om.init_state("cpu")
    obs = om.obs_dense(y)
    state = tg.pf_initialize(_gen(seed), model, (1, x0), obs, n)
    return state, x0, obs


def _update(state, x0, obs, donate, seed=6):
    return tg.pf_update(_gen(seed), state, (2, x0), (Extend(1), NoChange()),
                        obs, check=False, donate=donate)


def _mat_leaf(state):
    leaves, td = tree_flatten(state)
    i = next(i for i, x in enumerate(leaves)
             if x is state.traces.inner["store"].mat)
    return leaves, td, i


def test_the_public_update_leaves_its_input_untouched():
    state, x0, obs = _om_state()
    snap = _snapshot(state)
    with _writes() as w:
        out = _update(state, x0, obs, donate=False)
    assert w == {"copied": 1, "in_place": 0}
    assert _untouched(snap)
    assert (P.storage_of(out.traces.inner["store"].mat)
            != P.storage_of(state.traces.inner["store"].mat))


def test_a_donated_update_writes_the_incoming_store():
    state, x0, obs = _om_state()
    want = _update(state, x0, obs, donate=False)
    mat = state.traces.inner["store"].mat
    with _writes() as w:
        got = _update(state, x0, obs, donate=True)
    assert w == {"copied": 0, "in_place": 1}
    assert got.traces.inner["store"].mat is mat
    _assert_same(got, want)


def _as_view(state):
    leaves, td, i = _mat_leaf(state)
    big = torch.cat([leaves[i], leaves[i][:1]])
    leaves[i] = big[:leaves[i].shape[0]]
    return tree_unflatten(td, leaves), None


def _shared_with_a_leaf(state):
    leaves, td, i = _mat_leaf(state)
    j = next(j for j, x in enumerate(leaves) if isinstance(x, torch.Tensor)
             and x.dtype == torch.int32 and x.dim() == 1)   # the parents
    leaves[j] = leaves[i][0]
    return tree_unflatten(td, leaves), None


def _a_static_input(state):
    mat = state.traces.inner["store"].mat
    return state, frozenset([P.storage_of(mat)])


@pytest.mark.parametrize("case", [_as_view, _shared_with_a_leaf,
                                  _a_static_input],
                         ids=["view", "shared", "static_input"])
def test_a_store_that_is_not_whole_and_own_is_copied(case, monkeypatch):
    state, x0, obs = _om_state()
    state, inputs = case(state)
    if inputs is not None:
        monkeypatch.setattr(P, "_STATIC", [inputs])
    want = _update(state, x0, obs, donate=False)
    snap = _snapshot(state)
    with _writes() as w:
        got = _update(state, x0, obs, donate=True)
    assert w == {"copied": 1, "in_place": 0}
    assert _untouched(snap)
    _assert_same(got, want)


def test_public_calls_count_one_copy_each():
    state, x0, obs = _om_state()
    with _writes() as w:
        for t in range(1, T):
            state = tg.pf_update(_gen(t), state, (t + 1, x0),
                                 (Extend(1), NoChange()), obs, check=False)
    assert w == {"copied": T - 1, "in_place": 0}


def test_a_view_ignores_donate():
    state, x0, obs = _om_state()
    snap = _snapshot(state)
    with _writes() as w:
        tg.pf_update(_gen(6), state[:20], (2, x0), (Extend(1), NoChange()),
                     obs, check=False, donate=True)
    assert w["in_place"] == 0
    assert _untouched(snap)


# --- the drivers ------------------------------------------------------------------

def _sv_run(device="cpu", n=64, t=T):
    p = sv.SVParams()
    y = sv.synthesize_sv_data(_gen(1, device), t, p)
    return lambda gen, ess_frac: sv.sv_particle_filter(gen, y, n, t, p,
                                                       ess_frac=ess_frac)


def _mot_run(device="cpu", n=64, t=T):
    p = mo.MOTParams()
    y = mo.synthesize_mot_data(_gen(7, device), t, p)
    return lambda gen, ess_frac: mo.mot_particle_filter(
        gen, y, n, t, p, ess_frac=ess_frac,
        resize_schedule=mo.mot_resize_schedule(n, t))


def _om_run(device="cpu", n=64, t=T):
    y, _ = om.synthesize_data(_gen(42, device), t, 3)
    return lambda gen, ess_frac: om.object_motion_filter(
        gen, y, n, t, ess_frac=ess_frac, resample_method="residual")


def _da_run(device="cpu", n=64, t=T):
    p = mo.MOTParams()
    y, _ = mo.synthesize_mot_da_data(_gen(8, device), t, p)
    return lambda gen, ess_frac: mo.mot_da_particle_filter(
        gen, y, n, t, p, ess_frac=ess_frac)


_DRIVERS = {"om": _om_run, "sv": _sv_run, "mot": _mot_run, "mot_da": _da_run}


@pytest.mark.parametrize("ess_frac", [0.5, 1.5])
@pytest.mark.parametrize("name", sorted(_DRIVERS))
def test_drivers_write_in_place_bit_equal_to_the_copy(name, ess_frac,
                                                      monkeypatch):
    run = _DRIVERS[name]()
    taken = []
    window = C.Unfold._regenerate_window

    def counted(self, *a, **kw):
        taken.append(1)
        return window(self, *a, **kw)
    monkeypatch.setattr(C.Unfold, "_regenerate_window", counted)
    with _writes() as w:
        got = run(_gen(11), ess_frac)
    moves = len(taken)
    # the initialize and T - 1 updates in place; SV's windowed moves
    # (inside the checks) still copy
    assert w == {"copied": moves, "in_place": T}
    assert (name == "sv") == (moves > 0)
    with monkeypatch.context() as mp:
        _old_writer(mp)
        with _writes() as w:
            want = run(_gen(11), ess_frac)
    assert w == {"copied": T + moves, "in_place": 0}
    assert len(taken) == 2 * moves
    _assert_same(got, want)


# --- on the card --------------------------------------------------------------------

def _captured(name, gen, device, ess_frac):
    """The cell's filter captured on ``gen``: ``(CapturedRun, T)``."""
    if name == "om.1m":
        y, _ = om.synthesize_data(_gen(42, device), 10, 3)
        return om.object_motion_filter_captured(
            gen, y, 1_000_000, 10, ess_frac=ess_frac,
            resample_method="residual"), 10
    if name == "sv.100k":
        p = sv.SVParams()
        y = sv.synthesize_sv_data(_gen(1, device), 100, p)
        return cap.capture(sv.sv_particle_filter, gen, y, 100_000, 100, p,
                           ess_frac=ess_frac), 100
    p = mo.MOTParams()
    y = mo.synthesize_mot_data(_gen(7, device), 10, p)
    return mo.mot_particle_filter_captured(
        gen, y, 1_000_000, 10, p, ess_frac=ess_frac,
        resize_schedule=mo.mot_resize_schedule(1_000_000, 10)), 10


def _eager(name, gen, device, ess_frac):
    if name == "om.1m":
        return _om_run(device, 1_000_000, 10)(gen, ess_frac)
    if name == "sv.100k":
        return _sv_run(device, 100_000, 100)(gen, ess_frac)
    return _mot_run(device, 1_000_000, 10)(gen, ess_frac)


def _memcpys(events, mark):
    """``Memcpy DtoD`` device records that start inside the host span
    ``mark``."""
    span = [e for e in events if e.name() == mark
            and e.device_type().name != "CUDA"][0]
    t0, t1 = span.start_ns(), span.start_ns() + span.duration_ns()
    return sum(1 for e in events if e.device_type().name == "CUDA"
               and e.name().startswith("Memcpy DtoD")
               and t0 <= e.start_ns() <= t1)


@pytest.mark.chip
@pytest.mark.parametrize("name", ["om.1m", "sv.100k", "mot.1m"])
def test_captured_filters_write_in_place_on_the_card(card, name,
                                                     monkeypatch):
    from torch.profiler import ProfilerActivity, profile, record_function
    outs, runs = {}, {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        for form in ("donated", "copied"):
            with monkeypatch.context() as mp:
                if form == "copied":
                    mp.setattr(P, "may_overwrite",
                               lambda x, holder=None: False)
                gen = _gen(0, card)
                run, t_max = _captured(name, gen, card, 0.5)
            runs[form] = run.store_writes
            gen.manual_seed(11)
            with record_function(f"replay.{form}"):
                outs[form] = run()
                torch.cuda.synchronize()
            del run
            torch.cuda.empty_cache()
    finally:
        prof.stop()
    events = list(prof.profiler.kineto_results.events())
    copies = {f: _memcpys(events, f"replay.{f}") for f in outs}
    print(name, runs, "Memcpy DtoD a replay:", copies)
    assert runs["donated"]["copied"] == 0
    assert runs["donated"]["in_place"] == t_max
    assert runs["copied"] == {"copied": t_max, "in_place": 0}
    assert copies["copied"] - copies["donated"] == t_max
    _assert_same(outs["donated"], outs["copied"])
    del outs
    # every check taken: the replay draws what the eager run draws
    gen = _gen(0, card)
    run, _ = _captured(name, gen, card, 1.5)
    gen.manual_seed(13)
    got = run()
    want = _eager(name, _gen(13, card), card, 1.5)
    _assert_same(got, want)
