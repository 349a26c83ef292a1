"""Combinators: ``Unfold`` (state-space scan) and ``MapCombinator``
(plate), under a batched interpretation and per particle (inside a
``vmap_gfi`` map, where the packed storage takes its per-particle form,
``mat [T*R]``, and every write is out of place).

An ``Unfold(step, max_steps)`` trace holds the step sub-traces stacked
along a static time axis in packed step storage (core/packed.py,
``mat [T*R, N]``) plus the active length ``t`` — a Python int, shared by
all particles — and the carry cache: the state carried out of the last
active step, one ``[N]`` tensor per leaf. A trace reached through
``mask_trace`` also holds an ``outer_mask`` (static ``False`` or a
per-particle bool): old steps are present only where it is set.

Interpreters: ``generate`` (an empty trace extended over the active
steps), the O(k) ``Extend(k)`` update, the O(window) rejuvenation paths
(``regenerate_delta`` / ``apply_regenerate_delta``,
``_regenerate_window``, ``_sel_logp_window``) and the full re-scans
(``simulate``, ``assess``, ``_update``, ``_regenerate``, ``_sel_logp``).
The JAX package scans all ``T`` steps under ``lax.cond``; here the active
length is a Python int, so a re-scan loops over the active steps only and
leaves the rows of inactive steps (unspecified in both packages) as they
were.

Per-timestep (int-keyed) constraints and selections such as
``("line", 3, "y")`` reach the step they name as that step's own
entries, so a host value enters by a fill kernel and no device mask is
read; where they decide the layout (an empty trace) they count as the
JAX package's dense ``[T]``-masked entries: the site is stored per
particle.

Combinators nest. An Unfold inside an Unfold step keeps its active length
a Python int: the outer store records the inner lengths as a
:class:`~.packed.StaticColumn` (one value per outer step, no device
column), and the inner packed store packs into the outer ``mat`` rows. A
``MapCombinator`` of an Unfold keeps the elements' common length a Python
int and stacks each element leaf at the plate axis in front, or after the
particle axis where that leads; choices, masks and selects of such
stacked traces go element by element (or step by step), so no reader
ever sees an inner store with extra leading axes.
"""

from __future__ import annotations

import contextlib

import torch

from .choicemap import ChoiceMap, Entry, Selection, EMPTY
from .gfi import (GenFn, Trace, Extend, NoChange, current_batch, _where_lead,
                  _to_batch, _batch_tree, _assess_device, ABSTRACT)
from .packed import (StepStorage, StaticColumn, make_storage, unpack_tree,
                     read_step, write_steps, zeros_column, pack_column,
                     fits_layout, holds_store, put_extra, put_rows)
from .tree import (tree_leaves, tree_map, tree_flatten, tree_unflatten,
                   flatten_up_to)

__all__ = ["Unfold", "MapCombinator"]


def _inner_c(store, t, carry, outer_mask=True):
    """Unfold trace payload: the packed step storage, the active length,
    the outer mask (its key exists only when the mask is not ``True``) and
    the ``carry`` cache — the retval tree AFTER the last active step. The
    cache is kept only for SCALAR-per-particle carries (``[b]`` leaves
    under batched interpretation): a wide carry would cost a transpose in
    every resampling pack, where the row read it replaces is cheap."""
    d = {"store": store, "t": t}
    if outer_mask is not True:
        d["outer_mask"] = outer_mask
    b = current_batch()
    want = () if b is None else (b,)
    for leaf in tree_leaves(carry):
        if tuple(leaf.shape) != want:
            return d
    d["carry"] = carry
    return d


def _outer_mask(tr: Trace):
    return tr.inner.get("outer_mask", True)


def _trace_carry(tr: Trace):
    """The carry cache, or the stored row read when absent."""
    c = tr.inner.get("carry")
    if c is not None:
        return c
    return read_step(tr.inner["store"], max(tr.inner["t"] - 1, 0))["retval"]


def _slim_steps(steps: Trace) -> Trace:
    """Drop per-step args/retval and the per-step score from a step trace:
    the carried states are stored separately as the retval rows, and the
    old step score is recomputed by the ``_sel_logp`` pass. The score slot
    keeps a width-0 placeholder so the tree structure is unchanged."""
    score = torch.zeros(tuple(steps.score.shape) + (0,), dtype=torch.float32,
                        device=steps.score.device)
    return Trace(steps.gen_fn, (), None, score, steps.inner)


def _col_tree(steps_col, state):
    """Per-step logical column: the slimmed step trace + the retval carry
    (they live side by side in the packed storage)."""
    return {"retval": state, "steps": steps_col}


def _zeros(b, device):
    """A float32 accumulator: ``[b]`` under a batched interpretation, 0-d
    per particle."""
    return torch.zeros(() if b is None else (b,), dtype=torch.float32,
                       device=device)


def _storage_spec(unfold, stacked, b):
    """The particle-axis spec of a logical stacked column tree, derived on
    the per-particle tree when ``b`` is None (see perparticle_specs)."""
    from .batching import gen_spec, perparticle_specs
    with perparticle_specs() if b is None else contextlib.nullcontext():
        return _col_tree(unfold.step.trace_axes(stacked["steps"], 1),
                         gen_spec(stacked["retval"], 1, b))


def _batch_state0(state0, b, device):
    """Every carried-state leaf with a leading particle axis, as the JAX
    package's full scans carry it: shared initial states broadcast, so a
    carry computed from them (the line model's ``x = t + 1``) is stored per
    particle on every path."""
    return tree_map(lambda l: _to_batch(l, b, device), state0)


def _where_state(m, new, old):
    """``new`` where the presence mask ``m`` (True, False or a
    per-particle bool) holds, else ``old``, leaf by leaf."""
    if m is True:
        return new
    if m is False:
        return old
    return tree_map(lambda a, b: _where_lead(m, a, b), new, old)


def _and_lead(mask, active):
    """AND an entry mask (over the leading axes of its value) with a
    time-leading activity mask ``active`` ([T] or [T, b])."""
    if mask is False:
        return False
    if mask is True:
        return active
    m = torch.as_tensor(mask).to(torch.bool)
    a = active
    if m.dim() < a.dim():
        m = m.reshape(tuple(m.shape) + (1,) * (a.dim() - m.dim()))
    else:
        a = a.reshape(tuple(a.shape) + (1,) * (m.dim() - a.dim()))
    return torch.logical_and(m, a)


def _stack_padded(states, T):
    """Stack a list of per-step state trees (``len <= T``) along a new
    leading time axis, repeating the last one up to ``T`` steps (the JAX
    full scans carry the last active state through inactive steps)."""
    states = states + [states[-1]] * (T - len(states))

    def stack(*xs):
        xs = [torch.as_tensor(x) for x in xs]
        shape = torch.broadcast_shapes(*[tuple(x.shape) for x in xs])
        return torch.stack([x.expand(shape) for x in xs])
    return tree_map(stack, *states)


def _select_store(accept, new_st: StepStorage, old_st: StepStorage):
    """``where(accept, new, old)`` over two stores of one layout: ``mat``
    at its lane (particle) axis, each extra at the particle axis its spec
    records. Extras shared across particles (an observation stored once,
    the per-step lengths of an inner Unfold) hold the same kept value on
    both sides and come from ``new_st`` unselected."""
    def at(pax, a, b):
        if a is b:
            return a
        c = accept
        if c.dim():
            c = c.reshape((1,) * pax + (-1,) + (1,) * (a.dim() - pax - 1))
        return torch.where(c, a, b)
    mat = None if new_st.mat is None else at(1, new_st.mat, old_st.mat)
    extras = list(new_st.extras)
    for s in new_st.layout.specs:
        if s.kind == 1 and s.pax is not None:   # _KIND_EXTRA
            extras[s.off] = at(s.pax, extras[s.off], old_st.extras[s.off])
    return StepStorage(mat, extras, new_st.layout)


def _zeros_stacked(col, T, device):
    """Structural zeros of a column tree stacked over ``T`` steps: tensors
    ``[T, ...]``, Python numbers a :class:`StaticColumn` of zeros."""
    return tree_map(
        lambda l: (StaticColumn([type(l)(0)] * T)
                   if isinstance(l, (bool, int, float))
                   else torch.zeros((T,) + tuple(l.shape), dtype=l.dtype,
                                    device=device)), col)


def _stack_masks(masks, device, d):
    """Stack entry masks (each True, False or a bool tensor over the
    leading axes of its value) at axis ``d``, or at 0 where they are too
    short to reach it; a static True or False becomes a full tensor of the
    other masks' shape."""
    if all(m is True for m in masks):
        return True
    shapes = [tuple(m.shape) for m in masks if isinstance(m, torch.Tensor)]
    shape = torch.broadcast_shapes(*shapes) if shapes else ()
    ms = [torch.full(shape, bool(m), dtype=torch.bool, device=device)
          if isinstance(m, bool) else m.to(torch.bool).expand(shape)
          for m in masks]
    return torch.stack(ms, d if len(shape) >= d else 0)


def _stack_choicemaps(maps, dim_of) -> ChoiceMap:
    """One choicemap from same-keyed per-step or per-element maps, each
    entry's values (and masks) stacked at ``dim_of(address)``."""
    out = {}
    for k in maps[0].entries:
        es = [m.entries[k] for m in maps]
        vals = [torch.as_tensor(e.value) for e in es]
        shape = torch.broadcast_shapes(*[tuple(v.shape) for v in vals])
        d = dim_of(k)
        value = torch.stack([v.expand(shape) for v in vals], d)
        out[k] = Entry(value, _stack_masks([e.mask for e in es],
                                           value.device, d))
    return ChoiceMap(out)


class Unfold(GenFn):
    """Markov-chain combinator over a step generative function.

    ``step`` has signature ``step(t, state, *params) -> new_state``.
    ``Unfold(step, max_steps)`` is called with args ``(t_active,
    init_state, *params)`` where ``t_active`` is a Python int; the trace
    has static shape ``[max_steps, ...]`` with steps ``t >= t_active``
    inactive. Runs under a batched interpretation and per particle."""

    def __init__(self, step: GenFn, max_steps: int):
        self.step = step
        self.T = int(max_steps)
        #: step bodies run on steps so far (an empty trace's layout probe
        #: is not counted): the O(k) extension runs one per new step, a
        #: full re-scan one per active step and pass (a regenerate that
        #: recomputes sel_old runs two)
        self.steps_run = 0

    @property
    def batch_safe(self):
        return self.step.batch_safe

    def __repr__(self):
        return f"Unfold({self.step!r}, T={self.T})"

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _split_args(args):
        if isinstance(args[0], torch.Tensor):
            raise TypeError(
                "Unfold: the active length (args[0]) is a tensor; pass a "
                "Python int (inside a step, compute it from the step index "
                "and model constants), so that no device value is read")
        return int(args[0]), args[1], tuple(args[2:])

    def _ran(self, k):
        """Count ``k`` step bodies run (not while the layout guard runs
        the program on fake tensors)."""
        if not ABSTRACT:
            self.steps_run += k

    def _check_length(self, t):
        if not 0 <= t <= self.T:
            raise ValueError(f"t_active={t} outside [0, {self.T}]")

    def active_mask(self, tr: Trace):
        """Bool mask of the ACTIVE steps: ``[T]``, or ``[b, T]`` under a
        per-particle outer mask. Retval and choice slots at inactive steps
        are unspecified: mask any per-step read with this."""
        a = torch.arange(self.T, device=tr.score.device) < tr.inner["t"]
        om = _outer_mask(tr)
        if om is True:
            return a
        if om is False:
            return torch.zeros_like(a)
        return torch.logical_and(a, om[..., None] if om.dim() else om)

    def _active_tb(self, t_active, outer_mask, device):
        """Interpreter-internal active mask in TIME-LEADING orientation:
        ``[T]``, or ``[T, b]`` under a per-particle outer mask."""
        a = torch.arange(self.T, device=device) < t_active
        if outer_mask is True:
            return a
        if outer_mask is False:
            return torch.zeros_like(a)
        om = outer_mask.to(torch.bool)
        return torch.logical_and(a.reshape((self.T,) + (1,) * om.dim()),
                                 om[None])

    @staticmethod
    def _old_active(t, t_old, outer_mask):
        """Presence of old step ``t`` in a re-scan: absent past the old
        length, else the outer mask."""
        return False if t >= t_old else outer_mask

    def _slice_cm(self, cm: ChoiceMap) -> ChoiceMap:
        """Dense per-address entries with a leading T axis. Entries whose
        mask is the static True stay statically constrained, so handlers
        store those sites SHARED and never sample them."""
        out = {}
        for k, e in cm.entries.items():
            v = torch.as_tensor(e.value)
            if v.dim() == 0 or v.shape[0] != self.T:
                v = v.expand((self.T,) + tuple(v.shape))
            if e.mask is True:
                m = True
            else:
                m = torch.as_tensor(e.mask).to(torch.bool)
                if m.dim() == 0 or m.shape[0] != self.T:
                    m = m.expand((self.T,) + tuple(m.shape))
            out[k] = Entry(v, m)
        return ChoiceMap(out)

    def _densify(self, cm: ChoiceMap):
        """``(dense, by_t)``: the dense ``[T]``-leading entries of the
        str-keyed part, and the int-keyed part as ``{t: sub-map}``."""
        by_t = cm.int_keyed()
        for t in by_t:
            if not 0 <= t < self.T:
                raise IndexError(
                    f"constraint timestep {t} out of range [0,{self.T})")
        return self._slice_cm(cm.str_keyed()), by_t

    @staticmethod
    def _step_cm(dense: ChoiceMap, by_t, t: int) -> ChoiceMap:
        """Step ``t``'s constraints: the dense slice, where the int-keyed
        entries for ``t`` win (the JAX package's densify merge)."""
        cm = ChoiceMap({k: Entry(e.value[t],
                                 True if e.mask is True else e.mask[t])
                        for k, e in dense.entries.items()})
        sub = by_t.get(t)
        return cm if sub is None else cm.merge(sub)

    def _layout_cm(self, dense: ChoiceMap, by_t, device) -> ChoiceMap:
        """Step-0 constraints that decide an empty trace's layout: an
        address constrained per timestep is a dense ``[T]``-masked entry
        in the JAX package, so it is stored per particle; a bool-tensor
        mask (unset here) makes the handler take that path."""
        forced = {}
        for sub in by_t.values():
            for k, e in sub.entries.items():
                forced.setdefault(k, Entry(
                    e.value, torch.zeros((), dtype=torch.bool,
                                         device=device)))
        return self._step_cm(dense, {}, 0).merge(ChoiceMap(forced))

    def _slice_sel(self, sel: Selection) -> Selection:
        if sel.all_:
            return sel
        out = {}
        for k, m in sel.entries.items():
            if m is True or m is False:
                out[k] = m
            else:
                mm = torch.as_tensor(m).to(torch.bool)
                if mm.dim() == 0 or mm.shape[0] != self.T:
                    mm = mm.expand((self.T,) + tuple(mm.shape))
                out[k] = mm
        return Selection(out)

    def _densify_selection(self, sel: Selection):
        """``(dense, by_t)`` of a selection, as :meth:`_densify`."""
        if sel.all_:
            return sel, {}
        return self._slice_sel(sel.str_keyed()), sel.int_keyed()

    @staticmethod
    def _step_sel(dsel: Selection, by_t, t: int) -> Selection:
        """Step ``t``'s selection: the dense slice OR the int-keyed
        entries for ``t``."""
        if dsel.all_:
            return dsel
        out = {k: (m if isinstance(m, bool) else m[t])
               for k, m in dsel.entries.items()}
        sub = by_t.get(t)
        if sub is not None:
            for k, m in sub.entries.items():
                prev = out.get(k, False)
                if prev is False or m is True:
                    out[k] = m
                elif prev is not True and m is not False:
                    out[k] = torch.logical_or(prev, m)
        return Selection(out)

    def trace_retval(self, tr: Trace):
        """Materialized stacked retval carries [T, N, ...] (only the
        retval rows of the store are read)."""
        return unpack_tree(tr.inner["store"], "retval")

    # -- packed storage ---------------------------------------------------
    def _write_cols(self, store: StepStorage, t0: int, cols, b):
        """``store`` with the per-step columns ``cols`` written from step
        ``t0``. Where a value with a particle axis lands in a leaf stored
        shared, the layout is rebuilt from the written values, as the JAX
        package's full scans derive it from their outputs."""
        if not cols:
            return store
        if fits_layout(store, cols):
            return write_steps(store, t0, cols)
        leaves, td = tree_flatten(unpack_tree(store))
        col_leaves = [flatten_up_to(td, c) for c in cols]
        out = []
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, StaticColumn):
                for j, cl in enumerate(col_leaves):
                    leaf = leaf.with_value(t0 + j, cl[i])
                out.append(leaf)
                continue
            vals = [torch.as_tensor(cl[i]) for cl in col_leaves]
            per = tuple(leaf.shape[1:])
            shape = torch.broadcast_shapes(per,
                                           *[tuple(v.shape) for v in vals])
            x = leaf.reshape((self.T,) + (1,) * (len(shape) - len(per))
                             + per).expand((self.T,) + shape)
            rows = [x[t] for t in range(self.T)]
            for j, v in enumerate(vals):
                rows[t0 + j] = v.to(device=x.device,
                                    dtype=x.dtype).expand(shape)
            out.append(torch.stack(rows))
        stacked = tree_unflatten(td, out)
        return make_storage(stacked, _storage_spec(self, stacked, b),
                            self.T, batched=b is not None)

    # -- GFI --------------------------------------------------------------
    def _empty_trace(self, gen, args, constraints: ChoiceMap = EMPTY):
        """A t_active=0 trace: structural zeros. The layout comes from one
        constrained step-0 generate (it draws from ``gen``) on the batched
        initial state, so it is the layout the JAX package's full scans
        give: sites fully constrained by dense entries are stored SHARED,
        sites constrained per timestep and carries per particle."""
        b = current_batch()
        device = gen.device
        _, state0, params = self._split_args(args)
        dense, by_t = self._densify(constraints)
        state0 = _batch_state0(state0, b, device)
        step_tr, _ = self.step.generate(gen, (0, state0) + params,
                                        self._layout_cm(dense, by_t, device))
        col = _col_tree(_slim_steps(step_tr), step_tr.get_retval())
        stacked = _zeros_stacked(col, self.T, device)
        store = make_storage(stacked, _storage_spec(self, stacked, b),
                             self.T, batched=b is not None)
        carry = tree_map(torch.zeros_like, step_tr.get_retval())
        score = _zeros(b, device)
        return Trace(self, (0, state0) + params, None, score,
                     _inner_c(store, 0, carry))

    def generate(self, gen, args, constraints: ChoiceMap = EMPTY):
        """Build the trace by extending an empty trace over the ``t_active``
        steps (weight = score − logq = Σ log p(constrained))."""
        k = self._split_args(args)[0]
        self._check_length(k)
        tr0 = self._empty_trace(gen, args, constraints)
        if k == 0:
            return (Trace(self, args, None, tr0.score, tr0.inner),
                    torch.zeros_like(tr0.score))
        new_tr, logq, _ = self._update_extend(gen, tr0, args, constraints, k)
        return new_tr, new_tr.score - logq

    def simulate(self, gen, args):
        """Unconstrained generate: every active step sampled."""
        return self.generate(gen, args, EMPTY)[0]

    def assess(self, args, choices: ChoiceMap):
        """``(stacked states, score)`` of the active steps run on
        ``choices``, every address of which must be covered at every
        active step (a device mask is read to check it; inside a
        ``vmap_gfi`` map, when the map returns)."""
        from .batching import check_later
        b = current_batch()
        t_active, state0, params = self._split_args(args)
        self._check_length(t_active)
        device = _assess_device(args, choices)
        dense, by_t = self._densify(choices)
        for k, e in dense.entries.items():
            if e.mask is not True and t_active:
                def missing(k=k):
                    raise ValueError(f"assess: address {k} missing at "
                                     "some active timesteps")
                check_later(torch.logical_not(
                    e.mask[:t_active].reshape(t_active, -1).all()), missing)
        for k in {k for sub in by_t.values() for k in sub.entries}:
            if k not in dense.entries and any(
                    k not in by_t.get(t, EMPTY).entries
                    for t in range(t_active)):
                raise ValueError(f"assess: address {k} missing at some "
                                 "active timesteps")
        state = _batch_state0(state0, b, device)
        score = _zeros(b, device)
        states = [state]
        for t in range(t_active):
            state, s = self.step.assess((t, state) + params,
                                        self._step_cm(dense, by_t, t))
            self._ran(1)
            score = score + s
            states.append(state)
        return _stack_padded(states[1:] or states, self.T), score

    def _update(self, gen, tr: Trace, new_args, constraints: ChoiceMap,
                argdiffs=None):
        if (argdiffs is not None and len(argdiffs) >= 1
                and isinstance(argdiffs[0], Extend)
                and all(isinstance(d, NoChange) for d in argdiffs[1:])
                and _outer_mask(tr) is True):
            return self._update_extend(gen, tr, new_args, constraints,
                                       argdiffs[0].k)
        return self._update_full(gen, tr, new_args, constraints)

    def _update_full(self, gen, tr: Trace, new_args, constraints: ChoiceMap):
        """The full re-scan update: every new active step is updated from
        its old column (present where ``t < t_old`` and the outer mask
        holds). Discards: the overwritten choices of the new active steps,
        and the choices of the steps a shrinking ``t`` deactivates."""
        b = current_batch()
        t_new, state0, params = self._split_args(new_args)
        self._check_length(t_new)
        t_old, om = tr.inner["t"], _outer_mask(tr)
        store = tr.inner["store"]
        device = tr.score.device
        dense, by_t = self._densify(constraints)
        state = _batch_state0(state0, b, device)
        score = _zeros(b, device)
        logq = torch.zeros((), dtype=torch.float32, device=device)
        cols, discs = [], []
        for t in range(t_new):
            old_step = self.step.mask_trace(
                read_step(store, t)["steps"],
                self._old_active(t, t_old, om))
            new_step, logq_t, disc_t = self.step._update(
                gen, old_step, (t, state) + params,
                self._step_cm(dense, by_t, t))
            self._ran(1)
            state = new_step.get_retval()
            cols.append(_col_tree(_slim_steps(new_step), state))
            score = score + new_step.score
            logq = logq + logq_t
            discs.append(disc_t)
        discard = self._stack_discards(discs, device).merge(
            self._shrink_discard(tr, t_new, t_old, om, device))
        inner = _inner_c(self._write_cols(store, 0, cols, b), t_new, state)
        return Trace(self, new_args, None, score, inner), logq, discard

    def _stack_discards(self, discs, device) -> ChoiceMap:
        """Per-step discard maps -> dense ``[T]``-leading entries (value
        zeros and mask unset at steps that discarded nothing). Only
        addresses some step discarded appear, so an update that
        overwrote nothing returns an empty map and nothing is read. The
        rows are stacked, not written, so per-particle values stack too."""
        keys = []
        for d in discs:
            keys += [k for k in d.entries if k not in keys]
        out = {}
        for k in keys:
            present = {t: d.entries[k] for t, d in enumerate(discs)
                       if k in d.entries}
            vals = {t: torch.as_tensor(e.value).to(device)
                    for t, e in present.items()}
            vshape = torch.broadcast_shapes(
                *[tuple(v.shape) for v in vals.values()])
            mshape = torch.broadcast_shapes(
                *[tuple(e.mask.shape) for e in present.values()
                  if isinstance(e.mask, torch.Tensor)], ())
            dtype = next(iter(vals.values())).dtype
            zero = torch.zeros(vshape, dtype=dtype, device=device)
            unset = torch.zeros(mshape, dtype=torch.bool, device=device)
            full = torch.ones(mshape, dtype=torch.bool, device=device)
            value = torch.stack([vals[t].expand(vshape) if t in vals
                                 else zero for t in range(self.T)])
            mask = torch.stack([
                unset if t not in present else full
                if present[t].mask is True else present[t].mask.expand(mshape)
                for t in range(self.T)])
            out[k] = Entry(value, mask)
        return ChoiceMap(out)

    def _shrink_discard(self, tr, t_new, t_old, om, device) -> ChoiceMap:
        """The old choices of the steps in ``[t_new, t_old)``."""
        if t_new >= t_old or om is False:
            return EMPTY
        old = self._stacked_choices(tr.inner["store"])
        steps = torch.arange(self.T, device=device)
        shrink = torch.logical_and(steps >= t_new, steps < t_old)
        if om is not True:
            shrink = torch.logical_and(
                shrink.reshape((self.T,) + (1,) * om.dim()), om[None])
        return ChoiceMap({k: Entry(e.value, _and_lead(e.mask, shrink))
                          for k, e in old.entries.items()})

    def _update_extend(self, gen, tr: Trace, new_args,
                       constraints: ChoiceMap, k: int):
        """O(k) trace extension: run only the k newly activated steps and
        write their rows into a copy of the packed storage."""
        b = current_batch()
        t_new, state0, params = self._split_args(new_args)
        t_old = tr.inner["t"]
        if t_new != t_old + k or t_new > self.T:
            raise ValueError(
                f"Extend({k}) from t={t_old} must reach t={t_old + k} <= "
                f"max_steps={self.T}, got new active length {t_new}")
        old_store = tr.inner["store"]
        dense, by_t = self._densify(constraints)
        device = tr.score.device
        state = (_trace_carry(tr) if t_old > 0
                 else _batch_state0(state0, b, device))

        score_add = torch.zeros((), dtype=torch.float32, device=device)
        logq = torch.zeros((), dtype=torch.float32, device=device)
        # proto: a structurally identical step trace masked fully absent —
        # values never matter under a False mask
        proto = self.step.mask_trace(zeros_column(old_store)["steps"], False)
        cols = []
        for j in range(int(k)):
            t = t_old + j
            new_step, logq_t, _ = self.step._update(
                gen, proto, (t, state) + params,
                self._step_cm(dense, by_t, t))
            self._ran(1)
            state = new_step.get_retval()
            cols.append(_col_tree(_slim_steps(new_step), state))
            score_add = score_add + new_step.score
            logq = logq + logq_t

        store = self._write_cols(old_store, t_old, cols, b)
        inner = _inner_c(store, t_new, state)
        new_tr = Trace(self, new_args, None, tr.score + score_add, inner)
        return new_tr, logq, ChoiceMap({})

    def _window_start(self, tr: Trace, new_args, k: int):
        """(t_old, store, t_start, new-args state entering the window, old
        state entering it, params, old params)."""
        b = current_batch()
        device = tr.score.device
        _, state0, params = self._split_args(new_args)
        t_old = tr.inner["t"]
        store = tr.inner["store"]
        t_start = t_old - k
        if tr.args:
            _, old_state0, old_params = self._split_args(tr.args)
        else:
            old_state0, old_params = state0, params
        if t_start > 0:
            prev = read_step(store, t_start - 1)["retval"]
            return t_old, store, t_start, prev, prev, params, old_params
        return (t_old, store, t_start, _batch_state0(state0, b, device),
                _batch_state0(old_state0, b, device), params, old_params)

    def _window_pass(self, gen, tr: Trace, new_args, selection: Selection,
                     k: int):
        """Regenerate the last ``k`` active steps without writing them.
        Returns ``(cols, last_state, score_delta, sel_new, sel_old)``, where
        ``cols`` holds ``(t, slimmed step trace, retval)`` per window step
        and ``last_state`` is the state after the window."""
        (t_old, store, t_start, state, old_state, params,
         old_params) = self._window_start(tr, new_args, k)
        dsel, sel_by_t = self._densify_selection(selection)
        device = tr.score.device
        cols = []
        score_delta = torch.zeros((), dtype=torch.float32, device=device)
        sel_new = torch.zeros((), dtype=torch.float32, device=device)
        sel_old = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(max(t_start, 0), t_old):
            old_col = read_step(store, t)
            old_step = old_col["steps"]
            step_sel = self._step_sel(dsel, sel_by_t, t)
            # one forced old-value pass recovers BOTH the reverse-proposal
            # lp (sel_old) and the old step score
            _, so_t, old_score_t = self.step._sel_logp(
                old_step, (t, old_state) + old_params, step_sel)
            new_step, sn_t, _ = self.step._regenerate(
                gen, old_step, (t, state) + params, step_sel,
                need_sel_old=False)
            self._ran(2)
            state = new_step.get_retval()
            cols.append((t, _slim_steps(new_step), state))
            score_delta = score_delta + (new_step.score - old_score_t)
            sel_new = sel_new + sn_t
            sel_old = sel_old + so_t
            old_state = old_col["retval"]
        return cols, state, score_delta, sel_new, sel_old

    def regenerate_delta(self, gen, tr: Trace, new_args, argdiffs,
                         selection: Selection, window=None):
        """O(window) rejuvenation delta: recompute only the last ``window``
        active steps and return their columns; :meth:`apply_regenerate_delta`
        writes them under an accept mask. Without ``window`` (or under an
        outer mask) the delta is the full re-scan's new trace.

        Caller promise with ``window``: the selection only touches the last
        ``window`` active steps AND the args are unchanged."""
        if window is None or _outer_mask(tr) is not True:
            return super().regenerate_delta(gen, tr, new_args, argdiffs,
                                            selection, window=window)
        cols, state, score_delta, sel_new, sel_old = self._window_pass(
            gen, tr, new_args, selection, int(window))
        delta = {"cols": cols, "t_old": tr.inner["t"], "last_state": state,
                 "score_delta": score_delta, "new_args": new_args}
        return delta, score_delta - sel_new + sel_old

    def apply_regenerate_delta(self, tr: Trace, delta, accept):
        """The accepted-or-original trace from a regenerate delta: each
        window step's rows are selected by the per-particle ``accept`` mask
        and written into a copy of the packed storage."""
        if isinstance(delta, Trace):
            return super().apply_regenerate_delta(tr, delta, accept)
        cols = delta["cols"]
        store = tr.inner["store"]
        R = store.layout.R
        mat = store.mat
        extras = list(store.extras)
        # batched: the accept aligns with the LANE axis of mat [T*R, b],
        # and rows are written into copies; per particle (a 0-d accept):
        # written out of place
        per_particle = mat is not None and not store.batched
        shared = {s.off for s in store.layout.specs
                  if s.kind == 1 and s.pax is None}   # _KIND_EXTRA
        if cols and not per_particle:
            mat = None if mat is None else mat.clone()
            extras = [e if isinstance(e, StaticColumn) else e.clone()
                      for e in extras]
        for t, col, state in cols:
            cslab, extra_cols = pack_column(store, _col_tree(col, state))
            if cslab is not None:
                rows = mat[t * R:(t + 1) * R]
                if per_particle:
                    mat = put_rows(mat, t * R, torch.where(accept, cslab,
                                                           rows))
                else:
                    mat[t * R:(t + 1) * R] = torch.where(accept[None, :],
                                                         cslab, rows)
            # an extra stored shared holds the same kept value on both
            # sides: it is written unselected (per particle, a select would
            # give it the particle axis its layout keeps out)
            for i, v in enumerate(extra_cols):
                if v is None:
                    continue
                row = v if i in shared else _where_lead(accept, v,
                                                        extras[i][t])
                extras[i] = put_extra(extras[i], t, row, per_particle, True)
        new_store = StepStorage(mat, tuple(extras), store.layout)
        score = tr.score + torch.where(accept, delta["score_delta"], 0.0)
        # the window always ends at the last active step: the carry is the
        # delta's post-window state where accepted
        old_carry = _trace_carry(tr)
        if cols:
            carry = tree_map(lambda nw, od: _where_lead(accept, nw, od),
                             delta["last_state"], old_carry)
        else:
            carry = old_carry
        inner = _inner_c(new_store, delta["t_old"], carry)
        return Trace(self, delta["new_args"], None, score, inner)

    def _regenerate(self, gen, tr: Trace, new_args, selection: Selection,
                    window=None, old_args=None, need_sel_old=True):
        if window is not None and _outer_mask(tr) is True:
            return self._regenerate_window(gen, tr, new_args, selection,
                                           int(window))
        return self._regenerate_full(gen, tr, new_args, selection, old_args,
                                     need_sel_old)

    def _regenerate_full(self, gen, tr: Trace, new_args,
                         selection: Selection, old_args, need_sel_old):
        """The full re-scan regenerate. ``sel_old`` of each step is
        recomputed under the OLD args (``old_args``, else the stored ones,
        else ``new_args``) and the old carries entering it."""
        b = current_batch()
        t_new, state0, params = self._split_args(new_args)
        self._check_length(t_new)
        t_old, om = tr.inner["t"], _outer_mask(tr)
        store = tr.inner["store"]
        device = tr.score.device
        src = old_args if old_args is not None else tr.args
        if src:
            _, old_state0, old_params = self._split_args(src)
        else:
            old_state0, old_params = state0, params
        old_prev = _batch_state0(old_state0, b, device)
        state = _batch_state0(state0, b, device)
        dsel, sel_by_t = self._densify_selection(selection)
        score = _zeros(b, device)
        sel_new = torch.zeros((), dtype=torch.float32, device=device)
        sel_old = torch.zeros((), dtype=torch.float32, device=device)
        cols = []
        for t in range(t_new):
            old_col = read_step(store, t)
            old_step = self.step.mask_trace(old_col["steps"],
                                            self._old_active(t, t_old, om))
            new_step, sn_t, so_t = self.step._regenerate(
                gen, old_step, (t, state) + params,
                self._step_sel(dsel, sel_by_t, t),
                old_args=(t, old_prev) + old_params,
                need_sel_old=need_sel_old)
            self._ran(2 if need_sel_old else 1)
            state = new_step.get_retval()
            cols.append(_col_tree(_slim_steps(new_step), state))
            score = score + new_step.score
            sel_new = sel_new + sn_t
            sel_old = sel_old + so_t
            old_prev = old_col["retval"]
        inner = _inner_c(self._write_cols(store, 0, cols, b), t_new, state)
        return (Trace(self, new_args, None, score, inner), sel_new,
                sel_old)

    def _regenerate_window(self, gen, tr: Trace, new_args,
                           selection: Selection, k: int):
        """O(k) rejuvenation: recompute and rewrite only the last k active
        steps, in one slab write. Same caller promise as
        :meth:`regenerate_delta`."""
        cols, state, score_delta, sel_new, sel_old = self._window_pass(
            gen, tr, new_args, selection, k)
        store = tr.inner["store"]
        carry = _trace_carry(tr)
        if cols:
            store = self._write_cols(
                store, cols[0][0], [_col_tree(col, s) for _, col, s in cols],
                current_batch())
            carry = state
        inner = _inner_c(store, tr.inner["t"], carry)
        new_tr = Trace(self, new_args, None, tr.score + score_delta, inner)
        return new_tr, sel_new, sel_old

    def _sel_logp(self, tr: Trace, args, selection: Selection, window=None):
        """Force the old trace's values under ``args``: ``(stacked states,
        Σ selected old log-probs, Σ old log-probs)``. With ``window`` (the
        same promise as :meth:`regenerate_delta`) only the last ``window``
        steps are forced and the score term covers only them."""
        if window is not None and _outer_mask(tr) is True:
            return self._sel_logp_window(tr, args, selection, int(window))
        b = current_batch()
        _, state0, params = self._split_args(args)
        t_old, om = tr.inner["t"], _outer_mask(tr)
        store = tr.inner["store"]
        device = tr.score.device
        dsel, sel_by_t = self._densify_selection(selection)
        state = _batch_state0(state0, b, device)
        sel_old = torch.zeros((), dtype=torch.float32, device=device)
        score = torch.zeros((), dtype=torch.float32, device=device)
        states = [state]
        for t in range(t_old if om is not False else 0):
            old_step = read_step(store, t)["steps"]
            if om is not True:
                old_step = self.step.mask_trace(old_step, om)
            rv, so, sc = self.step._sel_logp(
                old_step, (t, state) + params,
                self._step_sel(dsel, sel_by_t, t))
            self._ran(1)
            state = _where_state(om, rv, state)
            states.append(state)
            sel_old = sel_old + so
            score = score + sc
        return _stack_padded(states[1:] or states, self.T), sel_old, score

    def _sel_logp_window(self, tr: Trace, args, selection: Selection,
                         k: int):
        """O(k) forced pass over the last k active steps (``args`` are the
        args the trace was produced under). Returns the stored retvals, the
        selected old log-probs and the windowed old score."""
        b = current_batch()
        _, state0, params = self._split_args(args)
        t_old = tr.inner["t"]
        store = tr.inner["store"]
        dsel, sel_by_t = self._densify_selection(selection)
        device = tr.score.device
        t_start = t_old - k
        old_state = (read_step(store, t_start - 1)["retval"] if t_start > 0
                     else _batch_state0(state0, b, device))
        sel_old = torch.zeros((), dtype=torch.float32, device=device)
        score = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(max(t_start, 0), t_old):
            old_col = read_step(store, t)
            _, so_t, sc_t = self.step._sel_logp(
                old_col["steps"], (t, old_state) + params,
                self._step_sel(dsel, sel_by_t, t))
            self._ran(1)
            sel_old = sel_old + so_t
            score = score + sc_t
            old_state = old_col["retval"]
        return self.trace_retval(tr), sel_old, score

    # -- structure --------------------------------------------------------
    def _stacked_choices(self, store: StepStorage) -> ChoiceMap:
        """The step choices of all ``T`` stored steps, stacked on a leading
        time axis. A column that holds another combinator's store (an
        Unfold in the step) is read step by step, so the inner store is
        only ever seen in its own per-step form."""
        if not holds_store(store.layout.treedef):
            return self.step.trace_choices(unpack_tree(store, "steps"))
        return _stack_choicemaps(
            [self.step.trace_choices(read_step(store, t)["steps"])
             for t in range(self.T)], lambda k: 0)

    def trace_choices(self, tr: Trace) -> ChoiceMap:
        """Stacked choices ``[T, N, ...]`` (shared sites ``[T, ...]``),
        each masked by the active steps (and the outer mask)."""
        stacked = self._stacked_choices(tr.inner["store"])
        active = self._active_tb(tr.inner["t"], _outer_mask(tr),
                                 tr.score.device)
        return ChoiceMap({k: Entry(e.value, _and_lead(e.mask, active))
                          for k, e in stacked.entries.items()})

    def mask_trace(self, tr: Trace, m) -> Trace:
        om = _outer_mask(tr)
        if m is True:
            new_om = om
        elif om is True or m is False:
            new_om = m
        elif om is False:
            new_om = False
        else:
            new_om = torch.logical_and(om, m)
        inner = {k: v for k, v in tr.inner.items() if k != "outer_mask"}
        if new_om is not True:
            inner["outer_mask"] = new_om
        return Trace(tr.gen_fn, tr.args, tr.retval, tr.score, inner)

    def batch_stored_args(self, tr: Trace, batch: int) -> Trace:
        """Sub-call storage: the initial state and params get the particle
        axis; the lockstep active length (``args[0]``) stays shared."""
        if not tr.args:
            return tr
        args = (tr.args[0],) + tuple(
            _batch_tree(a, batch, tr.score.device) for a in tr.args[1:])
        return Trace(self, args, tr.retval, tr.score, tr.inner)

    def select_trace(self, accept, new_tr: Trace, old_tr: Trace) -> Trace:
        """Accept/reject select keeping the lockstep active length and the
        args of the NEW trace. A per-particle ``[b]`` accept aligns with
        the LANE axis of the packed ``mat [T*R, b]``."""
        new_st, old_st = new_tr.inner["store"], old_tr.inner["store"]
        if (new_st.layout.specs != old_st.layout.specs
                or new_st.layout.R != old_st.layout.R):
            raise ValueError("select_trace: the two Unfold traces have "
                             "different storage layouts")
        store = _select_store(accept, new_st, old_st)
        om_new, om_old = _outer_mask(new_tr), _outer_mask(old_tr)
        if om_new is True and om_old is True:
            om = True
        else:
            def as_mask(m):
                if isinstance(m, bool):
                    return torch.full((), m, dtype=torch.bool,
                                      device=accept.device)
                return m
            om = _where_lead(accept, as_mask(om_new), as_mask(om_old))
        inner = {"store": store, "t": new_tr.inner["t"]}
        if om is not True:
            inner["outer_mask"] = om
        if "carry" in new_tr.inner and "carry" in old_tr.inner:
            inner["carry"] = tree_map(
                lambda nw, od: _where_lead(accept, nw, od),
                new_tr.inner["carry"], old_tr.inner["carry"])
        return Trace(self, new_tr.args, None,
                     _where_lead(accept, new_tr.score, old_tr.score), inner)

    def retval_axes(self, tr: Trace, axis: int = 0):
        """Particle-axis spec of the materialized stacked retval
        ``[T, N, ...]`` (time-major: the particle axis follows time)."""
        from .batching import gen_spec, spec_n
        return gen_spec(self.trace_retval(tr), axis + 1,
                        spec_n(tr.score, axis))

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        store = tr.inner["store"]
        if holds_store(store.layout.treedef):
            # one step's choices, one time axis in front
            return self.step.trace_choice_axes(read_step(store, 0)["steps"],
                                               axis + 1)
        steps = unpack_tree(store, "steps")
        return self.step.trace_choice_axes(steps, axis + 1)

    def trace_axes(self, tr: Trace, axis: int = 0, args_shared: bool = False):
        """Time-major layout: the packed ``mat [T*R, N]`` holds the particle
        axis at ``axis+1``; the active length ``t`` is always shared; each
        extra carries the particle-axis position its layout spec recorded
        (``None`` for shared leaves); a per-particle outer mask sits at
        ``axis``."""
        from .batching import gen_spec, const_spec, spec_n
        n = spec_n(tr.score, axis)
        inner = tr.inner
        store = inner["store"]
        mat_spec = None if store.mat is None else axis + 1
        extras_spec = [None] * len(store.extras)
        for s in store.layout.specs:
            if s.kind == 1:  # _KIND_EXTRA
                extras_spec[s.off] = None if s.pax is None else s.pax + axis
        spec_inner = {"store": StepStorage(mat_spec, tuple(extras_spec),
                                           store.layout),
                      "t": None}
        if "carry" in inner:
            spec_inner["carry"] = gen_spec(inner["carry"], axis, n)
        if "outer_mask" in inner:
            spec_inner["outer_mask"] = gen_spec(inner["outer_mask"], axis, n)
        if args_shared:
            args_spec = const_spec(tr.args, None)
        else:
            # sub-call position: the initial state and params derive from
            # per-particle upstream values; the active length stays shared
            args_spec = ((None,) + tuple(gen_spec(a, axis, n)
                                         for a in tr.args[1:])
                         if tr.args else ())
        return Trace(self, args_spec, None, axis, spec_inner)


class MapCombinator(GenFn):
    """IID plate combinator: the kernel applied to each of ``n`` elements.

    ``MapCombinator(kernel, n)`` is called with args that are shared
    (passed whole to every element) or plate-indexed (a leading ``[n]``
    axis, or ``[b, n, ...]`` per particle under batched interpretation);
    every address of the trace gets the plate axis. Each element is one
    interpretation of the kernel — batched over the particles under
    :class:`~.gfi.batched_interpretation` — on its slice of the args,
    constraints and old sub-trace; the element results stack the plate at
    axis 1 where they carry the particle axis (``[b, n, ...]``,
    particle-major) and at axis 0 otherwise (values shared across
    particles, such as a site constrained by one ``[n]`` observation)."""

    def __init__(self, kernel: GenFn, n: int):
        self.kernel = kernel
        self.n = int(n)

    @property
    def batch_safe(self):
        return self.kernel.batch_safe

    def __repr__(self):
        return f"MapCombinator({self.kernel!r}, n={self.n})"

    # -- per-element slicing and stacking ---------------------------------
    def _elem_leaf(self, x, i, b=None):
        """Element ``i`` of a leaf: ``[b, n, ...]`` at axis 1, ``[n, ...]``
        at axis 0, anything else passes whole. ``b`` is the particle count
        (default: the batched interpretation's)."""
        shape = getattr(x, "shape", None)
        if shape is None:
            return x
        b = current_batch() if b is None else b
        if b is not None and len(shape) >= 2 and shape[0] == b \
                and shape[1] == self.n:
            return x[:, i]
        if len(shape) >= 1 and shape[0] == self.n:
            return x[i]
        return x

    def _elem(self, tree, i, b=None):
        return tree_map(lambda x: self._elem_leaf(x, i, b), tree)

    @staticmethod
    def _nested(steps) -> bool:
        """Whether the element traces hold another combinator's packed
        store (a plate of Unfolds): the stacked form is then read and
        written element by element."""
        return holds_store(tree_flatten(steps)[1])

    def _lift(self, ax, axis):
        """An element leaf's particle axis -> the stacked leaf's: a leading
        particle axis stays (the plate follows it), any other moves one
        down (the plate is in front)."""
        return ax if ax is None or ax == axis else ax + 1

    def _restack(self, tr: Trace, elems) -> Trace:
        """``tr`` with its element traces replaced by ``elems``."""
        steps = self._stack(elems, tr.score.device)
        return Trace(self, tr.args, tr.retval, tr.score, {"steps": steps})

    def _elem_cm(self, cm: ChoiceMap, i) -> ChoiceMap:
        return ChoiceMap({k: Entry(self._elem_leaf(e.value, i),
                                   e.mask if isinstance(e.mask, bool)
                                   else self._elem_leaf(e.mask, i))
                          for k, e in cm.entries.items()})

    @staticmethod
    def _stack(outs, device):
        """Stack same-structured element results along the plate axis:
        at 1 for leaves with a leading particle axis, else at 0. Where the
        elements hold a packed store, the particle axis of each leaf is
        its spec (trace leaves by their ``trace_axes``), and a Python
        number the spec keeps shared — an Unfold's active length — stays a
        Python number, which every element must agree on (the elements run
        in lockstep)."""
        from .batching import gen_spec, perparticle_specs
        from .choicemap import value_on
        b = current_batch()
        all_leaves = [tree_flatten(o)[0] for o in outs]
        td = tree_flatten(outs[0])[1]
        if any(len(ls) != td.n_leaves for ls in all_leaves):
            raise ValueError("MapCombinator: the elements' results differ "
                             "in structure")
        if holds_store(td):
            with (perparticle_specs() if b is None
                  else contextlib.nullcontext()):
                axes = flatten_up_to(td, gen_spec(outs[0], 0, b))
        else:
            axes = [False] * td.n_leaves
        stacked = []
        for xs, p in zip(zip(*all_leaves), axes):
            if p is None and not isinstance(xs[0], torch.Tensor):
                if any(x != xs[0] for x in xs):
                    raise ValueError(
                        f"MapCombinator: the elements differ in a Python "
                        f"value their layout keeps shared ({list(xs)}); an "
                        f"Unfold under a plate runs every element to one "
                        f"active length")
                stacked.append(xs[0])
                continue
            xs = [x if isinstance(x, torch.Tensor) else value_on(x, device)
                  for x in xs]
            shape = torch.broadcast_shapes(*[tuple(x.shape) for x in xs])
            if p is False:
                lead = len(shape) >= 1 and shape[0] == b
            else:
                lead = p == 0
            ax = 1 if (b is not None and lead) else 0
            stacked.append(torch.stack([x.expand(shape) for x in xs], ax))
        return tree_unflatten(td, stacked)

    @staticmethod
    def _psum(x):
        """Σ over the plate axis: [n] -> scalar, [b, n] -> [b]."""
        return x.sum() if x.dim() == 1 else x.sum(dim=1)

    def _store(self, tr: Trace) -> Trace:
        """An element trace with its stored args in the per-particle
        layout (see GenFn.batch_stored_args)."""
        b = current_batch()
        return tr if b is None else self.kernel.batch_stored_args(tr, b)

    def _mk(self, args, steps: Trace) -> Trace:
        return Trace(self, args, steps.retval, self._psum(steps.score),
                     {"steps": steps})

    # -- GFI --------------------------------------------------------------
    def simulate(self, gen, args):
        steps = self._stack([
            self._store(self.kernel.simulate(gen, self._elem(args, i)))
            for i in range(self.n)], gen.device)
        return self._mk(args, steps)

    def generate(self, gen, args, constraints: ChoiceMap = EMPTY):
        outs = []
        for i in range(self.n):
            tr, w = self.kernel.generate(gen, self._elem(args, i),
                                         self._elem_cm(constraints, i))
            outs.append((self._store(tr), w))
        steps, ws = self._stack(outs, gen.device)
        return self._mk(args, steps), self._psum(ws)

    def assess(self, args, choices: ChoiceMap):
        device = _assess_device(args, choices)
        retvals, ss = self._stack([
            self.kernel.assess(self._elem(args, i),
                               self._elem_cm(choices, i))
            for i in range(self.n)], device)
        return retvals, self._psum(ss)

    def _update(self, gen, tr: Trace, new_args, constraints: ChoiceMap,
                argdiffs=None):
        outs = []
        for i in range(self.n):
            s, lq, d = self.kernel._update(
                gen, self._elem(tr.inner["steps"], i),
                self._elem(new_args, i), self._elem_cm(constraints, i))
            outs.append((self._store(s), lq, d.entries))
        steps, logqs, disc = self._stack(outs, tr.score.device)
        return self._mk(new_args, steps), self._psum(logqs), ChoiceMap(disc)

    def _regenerate(self, gen, tr: Trace, new_args, selection: Selection,
                    window=None, old_args=None, need_sel_old=True):
        outs = []
        for i in range(self.n):
            s, sn, so = self.kernel._regenerate(
                gen, self._elem(tr.inner["steps"], i),
                self._elem(new_args, i), selection,
                old_args=(None if old_args is None
                          else self._elem(tuple(old_args), i)),
                need_sel_old=need_sel_old)
            outs.append((self._store(s), sn, so))
        steps, sns, sos = self._stack(outs, tr.score.device)
        return self._mk(new_args, steps), self._psum(sns), self._psum(sos)

    def _sel_logp(self, tr: Trace, args, selection: Selection, window=None):
        retvals, sos, scs = self._stack([
            self.kernel._sel_logp(self._elem(tr.inner["steps"], i),
                                  self._elem(args, i), selection,
                                  window=window)
            for i in range(self.n)], tr.score.device)
        return retvals, self._psum(sos), self._psum(scs)

    # -- structure --------------------------------------------------------
    def _elems(self, tr: Trace):
        """The element traces of a stacked trace (particle count from its
        score: ``[b]`` batched, 0-d per particle)."""
        b = tr.score.shape[0] if tr.score.dim() else None
        return [self._elem(tr.inner["steps"], i, b) for i in range(self.n)]

    def trace_choices(self, tr: Trace) -> ChoiceMap:
        steps = tr.inner["steps"]
        if not self._nested(steps):
            return self.kernel.trace_choices(steps)
        elems = self._elems(tr)
        axes = self.kernel.trace_choice_axes(elems[0], 0)
        batched = tr.score.dim() > 0
        return _stack_choicemaps(
            [self.kernel.trace_choices(e) for e in elems],
            lambda k: 1 if batched and axes.get(k, 0) == 0 else 0)

    def mask_trace(self, tr: Trace, m) -> Trace:
        steps = tr.inner["steps"]
        if not self._nested(steps):
            return Trace(tr.gen_fn, tr.args, tr.retval, tr.score,
                         {"steps": self.kernel.mask_trace(steps, m)})
        if m is True:
            return tr
        return self._restack(tr, [self.kernel.mask_trace(e, m)
                                  for e in self._elems(tr)])

    def trace_axes(self, tr: Trace, axis: int = 0, args_shared: bool = False):
        """Particle-major throughout: every leaf under the plate has its
        particle axis at ``axis``; leaves without one are shared. Element
        traces that hold a packed store (an Unfold's ``mat [T*R, b]``)
        keep theirs where it is, one down: the plate goes in front."""
        from .batching import const_spec, gen_spec, spec_n
        n = spec_n(tr.score, axis)
        args_spec = (const_spec(tr.args, None) if args_shared
                     else gen_spec(tr.args, axis, n))
        steps = tr.inner["steps"]
        if self._nested(steps):
            if axis != 0:
                raise NotImplementedError(
                    "a MapCombinator of a combinator inside another "
                    "combinator's step")
            elem = self._elem(steps, 0, n)
            spec = self.kernel.trace_axes(elem, 0)
            steps_spec = tree_unflatten(
                tree_flatten(steps)[1],
                [self._lift(ax, 0) for ax in
                 flatten_up_to(tree_flatten(elem)[1], spec)])
        else:
            steps_spec = const_spec(steps, axis, n)
        return Trace(self, args_spec, const_spec(tr.retval, axis, n), axis,
                     {"steps": steps_spec})

    def select_trace(self, accept, new_tr: Trace, old_tr: Trace) -> Trace:
        """``where(accept, new, old)`` by the layout: leaves shared across
        particles (``trace_axes`` gives ``None``) come from ``new_tr``
        unselected — a shared ``[n]`` leaf must not meet a ``[b]``
        accept — and the stored args pass through from ``new_tr``.
        Element traces that hold a packed store select element by
        element."""
        if self._nested(new_tr.inner["steps"]):
            sel = self._restack(new_tr, [
                self.kernel.select_trace(accept, a, o) for a, o in
                zip(self._elems(new_tr), self._elems(old_tr))])
            return Trace(self, new_tr.args, new_tr.retval,
                         _where_lead(accept, new_tr.score, old_tr.score),
                         sel.inner)
        spec = self.trace_axes(new_tr)
        parts = lambda tr: (tr.retval, tr.score, tr.inner)  # noqa: E731
        new_l, td = tree_flatten(parts(new_tr))
        old_l = tree_flatten(parts(old_tr))[0]
        axes = flatten_up_to(td, parts(spec))
        out = [a if (ax is None or a is o) else _where_lead(accept, a, o)
               for a, o, ax in zip(new_l, old_l, axes)]
        retval, score, inner = tree_unflatten(td, out)
        return Trace(self, new_tr.args, retval, score, inner)

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        steps = tr.inner["steps"]
        if self._nested(steps):
            return {k: self._lift(ax, axis) for k, ax in
                    self.kernel.trace_choice_axes(self._elems(tr)[0],
                                                  axis).items()}
        return {k: axis for k in
                self.kernel.trace_choice_axes(steps, axis)}
