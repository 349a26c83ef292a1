"""``Unfold``: the state-space combinator, batched form.

An ``Unfold(step, max_steps)`` trace holds the step sub-traces stacked
along a static time axis in packed step storage (core/packed.py,
``mat [T*R, N]``) plus the active length ``t`` — a Python int, shared by
all particles — and the carry cache: the state carried out of the last
active step, one ``[N]`` tensor per leaf. Extension writes the new steps'
rows; nothing is reallocated.

Ported paths: ``generate`` (built by extending an empty trace), the O(k)
``Extend(k)`` update, and the O(window) rejuvenation paths
(``regenerate_delta`` / ``apply_regenerate_delta``, ``_regenerate_window``,
``_sel_logp_window``). The full re-scan interpreters wait for a later
slice, so every other update or regenerate raises.
"""

from __future__ import annotations

import torch

from .choicemap import ChoiceMap, Entry, Selection, EMPTY
from .gfi import GenFn, Trace, Extend, NoChange, current_batch, _where_lead
from .packed import (StepStorage, make_storage, unpack_tree, read_step,
                     write_steps, zeros_column, pack_column)
from .tree import tree_leaves, tree_map

__all__ = ["Unfold"]


def _inner_c(store, t, carry):
    """Unfold trace payload: the packed step storage, the active length and
    the ``carry`` cache — the retval tree AFTER the last active step. The
    cache is kept only for SCALAR-per-particle carries (``[b]`` leaves
    under batched interpretation): a wide carry would cost a transpose in
    every resampling pack, where the row read it replaces is cheap."""
    d = {"store": store, "t": t}
    b = current_batch()
    want = () if b is None else (b,)
    for leaf in tree_leaves(carry):
        if tuple(leaf.shape) != want:
            return d
    d["carry"] = carry
    return d


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


class Unfold(GenFn):
    """Markov-chain combinator over a step generative function.

    ``step`` has signature ``step(t, state, *params) -> new_state``.
    ``Unfold(step, max_steps)`` is called with args ``(t_active,
    init_state, *params)`` where ``t_active`` is a Python int; the trace
    has static shape ``[max_steps, ...]`` with steps ``t >= t_active``
    inactive. Batched interpretation only."""

    def __init__(self, step: GenFn, max_steps: int):
        self.step = step
        self.T = int(max_steps)
        #: step bodies run by the O(k) extension path — one per new step;
        #: a full re-scan would run all T
        self.steps_run = 0

    @property
    def batch_safe(self):
        return self.step.batch_safe

    def __repr__(self):
        return f"Unfold({self.step!r}, T={self.T})"

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _split_args(args):
        return int(args[0]), args[1], tuple(args[2:])

    @staticmethod
    def _batch():
        b = current_batch()
        if b is None:
            raise NotImplementedError(
                "Unfold runs under batched_interpretation only; the "
                "per-particle form is not ported yet")
        return b

    def _slice_cm(self, cm: ChoiceMap) -> ChoiceMap:
        """Dense per-address entries with a leading T axis. Entries whose
        mask is the static True stay statically constrained, so handlers
        store those sites SHARED and never sample them."""
        if cm.int_keyed():
            raise NotImplementedError(
                "per-timestep (int-keyed) constraints are not ported yet; "
                "pass dense [T, ...] entries with [T] masks")
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

    @staticmethod
    def _step_cm(dense: ChoiceMap, t: int) -> ChoiceMap:
        return ChoiceMap({k: Entry(e.value[t],
                                   True if e.mask is True else e.mask[t])
                          for k, e in dense.entries.items()})

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

    @staticmethod
    def _step_sel(dsel: Selection, t: int) -> Selection:
        if dsel.all_:
            return dsel
        return Selection({k: (m if isinstance(m, bool) else m[t])
                          for k, m in dsel.entries.items()})

    def trace_retval(self, tr: Trace):
        """Materialized stacked retval carries [T, N, ...] (cold path)."""
        return unpack_tree(tr.inner["store"])["retval"]

    # -- GFI --------------------------------------------------------------
    def _empty_trace(self, gen, args, constraints: ChoiceMap = EMPTY):
        """A t_active=0 trace: structural zeros. The layout comes from one
        constrained step-0 generate (it draws from ``gen``), so sites fully
        constrained by ``constraints`` are stored SHARED, exactly as the
        extension writes into this proto will store them."""
        b = self._batch()
        _, state0, params = self._split_args(args)
        dense = self._slice_cm(constraints)
        step_tr, _ = self.step.generate(gen, (0, state0) + params,
                                        self._step_cm(dense, 0))
        col = _col_tree(_slim_steps(step_tr), step_tr.get_retval())
        stacked = tree_map(
            lambda l: torch.zeros((self.T,) + tuple(l.shape), dtype=l.dtype,
                                  device=l.device), col)
        from .batching import gen_spec
        spec = _col_tree(self.step.trace_axes(stacked["steps"], 1),
                         gen_spec(stacked["retval"], 1, b))
        store = make_storage(stacked, spec, self.T)
        carry = tree_map(torch.zeros_like, step_tr.get_retval())
        score = torch.zeros((b,), dtype=torch.float32,
                            device=step_tr.score.device)
        return Trace(self, (0, state0) + params, None, score,
                     _inner_c(store, 0, carry))

    def generate(self, gen, args, constraints: ChoiceMap = EMPTY):
        """Build the trace by extending an empty trace over the ``t_active``
        steps (weight = score − logq = Σ log p(constrained))."""
        k = self._split_args(args)[0]
        if not 0 <= k <= self.T:
            raise ValueError(f"t_active={k} outside [0, {self.T}]")
        tr0 = self._empty_trace(gen, args, constraints)
        if k == 0:
            return tr0, torch.zeros_like(tr0.score)
        new_tr, logq, _ = self._update_extend(gen, tr0, args, constraints, k)
        return new_tr, new_tr.score - logq

    def _update(self, gen, tr: Trace, new_args, constraints: ChoiceMap,
                argdiffs=None):
        if (argdiffs is not None and len(argdiffs) >= 1
                and isinstance(argdiffs[0], Extend)
                and all(isinstance(d, NoChange) for d in argdiffs[1:])):
            return self._update_extend(gen, tr, new_args, constraints,
                                       argdiffs[0].k)
        raise NotImplementedError(
            "only the Extend(k) update of an Unfold is ported; the full "
            "re-scan update waits for a later slice")

    def _update_extend(self, gen, tr: Trace, new_args,
                       constraints: ChoiceMap, k: int):
        """O(k) trace extension: run only the k newly activated steps and
        write their rows into a copy of the packed storage."""
        t_new, state0, params = self._split_args(new_args)
        t_old = tr.inner["t"]
        if t_new != t_old + k or t_new > self.T:
            raise ValueError(
                f"Extend({k}) from t={t_old} must reach t={t_old + k} <= "
                f"max_steps={self.T}, got new active length {t_new}")
        old_store = tr.inner["store"]
        dense = self._slice_cm(constraints)
        state = _trace_carry(tr) if t_old > 0 else state0

        device = tr.score.device
        score_add = torch.zeros((), dtype=torch.float32, device=device)
        logq = torch.zeros((), dtype=torch.float32, device=device)
        # proto: a structurally identical step trace masked fully absent —
        # values never matter under a False mask
        proto = self.step.mask_trace(zeros_column(old_store)["steps"], False)
        cols = []
        for j in range(int(k)):
            t = t_old + j
            new_step, logq_t, _ = self.step._update(
                gen, proto, (t, state) + params, self._step_cm(dense, t))
            self.steps_run += 1
            state = new_step.get_retval()
            cols.append(_col_tree(_slim_steps(new_step), state))
            score_add = score_add + new_step.score
            logq = logq + logq_t

        store = write_steps(old_store, t_old, cols)
        inner = _inner_c(store, t_new, state)
        new_tr = Trace(self, new_args, None, tr.score + score_add, inner)
        return new_tr, logq, ChoiceMap({})

    def _window_start(self, tr: Trace, new_args, k: int):
        """(t_old, store, t_start, new-args state entering the window, old
        state entering it, params, old params)."""
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
        return t_old, store, t_start, state0, old_state0, params, old_params

    def _window_pass(self, gen, tr: Trace, new_args, selection: Selection,
                     k: int):
        """Regenerate the last ``k`` active steps without writing them.
        Returns ``(cols, last_state, score_delta, sel_new, sel_old)``, where
        ``cols`` holds ``(t, slimmed step trace, retval)`` per window step
        and ``last_state`` is the state after the window."""
        (t_old, store, t_start, state, old_state, params,
         old_params) = self._window_start(tr, new_args, k)
        dsel = self._slice_sel(selection)
        device = tr.score.device
        cols = []
        score_delta = torch.zeros((), dtype=torch.float32, device=device)
        sel_new = torch.zeros((), dtype=torch.float32, device=device)
        sel_old = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(max(t_start, 0), t_old):
            old_col = read_step(store, t)
            old_step = old_col["steps"]
            step_sel = self._step_sel(dsel, t)
            # one forced old-value pass recovers BOTH the reverse-proposal
            # lp (sel_old) and the old step score
            _, so_t, old_score_t = self.step._sel_logp(
                old_step, (t, old_state) + old_params, step_sel)
            new_step, sn_t, _ = self.step._regenerate(
                gen, old_step, (t, state) + params, step_sel,
                need_sel_old=False)
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
        writes them under an accept mask.

        Caller promise: the selection only touches the last ``window``
        active steps AND the args are unchanged."""
        if window is None:
            raise NotImplementedError(
                "Unfold.regenerate_delta needs window=k; the full re-scan "
                "regenerate is not ported yet")
        cols, state, score_delta, sel_new, sel_old = self._window_pass(
            gen, tr, new_args, selection, int(window))
        delta = {"cols": cols, "t_old": tr.inner["t"], "last_state": state,
                 "score_delta": score_delta, "new_args": new_args}
        return delta, score_delta - sel_new + sel_old

    def apply_regenerate_delta(self, tr: Trace, delta, accept):
        """The accepted-or-original trace from a regenerate delta: each
        window step's rows are selected by the per-particle ``accept`` mask
        and written into a copy of the packed storage."""
        cols = delta["cols"]
        store = tr.inner["store"]
        R = store.layout.R
        mat = store.mat
        extras = list(store.extras)
        if cols:
            mat = None if mat is None else mat.clone()
            extras = [e.clone() for e in extras]
        for t, col, state in cols:
            cslab, extra_cols = pack_column(store, _col_tree(col, state))
            if cslab is not None:
                rows = mat[t * R:(t + 1) * R]
                mat[t * R:(t + 1) * R] = torch.where(accept[None, :], cslab,
                                                     rows)
            # extras hold values shared across particles: both sides keep
            # the same old value under a per-particle accept
            for i, v in enumerate(extra_cols):
                if v is not None:
                    extras[i][t] = _where_lead(accept, v, extras[i][t])
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
        if window is None:
            raise NotImplementedError(
                "Unfold.regenerate needs window=k; the full re-scan "
                "regenerate is not ported yet")
        return self._regenerate_window(gen, tr, new_args, selection,
                                       int(window))

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
            store = write_steps(store, cols[0][0],
                                [_col_tree(col, s) for _, col, s in cols])
            carry = state
        inner = _inner_c(store, tr.inner["t"], carry)
        new_tr = Trace(self, new_args, None, tr.score + score_delta, inner)
        return new_tr, sel_new, sel_old

    def _sel_logp_window(self, tr: Trace, args, selection: Selection,
                         k: int):
        """O(k) forced pass over the last k active steps (``args`` are the
        args the trace was produced under). Returns the stored retvals, the
        selected old log-probs and the windowed old score."""
        _, state0, params = self._split_args(args)
        t_old = tr.inner["t"]
        store = tr.inner["store"]
        dsel = self._slice_sel(selection)
        t_start = t_old - k
        old_state = (read_step(store, t_start - 1)["retval"] if t_start > 0
                     else state0)
        device = tr.score.device
        sel_old = torch.zeros((), dtype=torch.float32, device=device)
        score = torch.zeros((), dtype=torch.float32, device=device)
        for t in range(max(t_start, 0), t_old):
            old_col = read_step(store, t)
            _, so_t, sc_t = self.step._sel_logp(
                old_col["steps"], (t, old_state) + params,
                self._step_sel(dsel, t))
            sel_old = sel_old + so_t
            score = score + sc_t
            old_state = old_col["retval"]
        return self.trace_retval(tr), sel_old, score

    # -- structure --------------------------------------------------------
    def trace_choices(self, tr: Trace) -> ChoiceMap:
        """Stacked choices ``[T, N, ...]`` (shared sites ``[T, ...]``),
        each masked by the active steps."""
        steps = unpack_tree(tr.inner["store"])["steps"]
        stacked = self.step.trace_choices(steps)
        active = (torch.arange(self.T, device=tr.score.device)
                  < tr.inner["t"])
        out = {}
        for k, e in stacked.entries.items():
            m = active if e.mask is True else torch.logical_and(
                e.mask, active.reshape((self.T,) + (1,) * (e.mask.dim() - 1)))
            out[k] = Entry(e.value, m)
        return ChoiceMap(out)

    def retval_axes(self, tr: Trace, axis: int = 0):
        """Particle-axis spec of the materialized stacked retval
        ``[T, N, ...]`` (time-major: the particle axis follows time). It
        materializes the retval to read its shapes: a cold path."""
        from .batching import gen_spec, spec_n
        return gen_spec(self.trace_retval(tr), axis + 1,
                        spec_n(tr.score, axis))

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        steps = unpack_tree(tr.inner["store"])["steps"]
        return self.step.trace_choice_axes(steps, axis + 1)

    def trace_axes(self, tr: Trace, axis: int = 0, args_shared: bool = False):
        """Time-major layout: the packed ``mat [T*R, N]`` holds the particle
        axis at ``axis+1``; the active length ``t`` is always shared; each
        extra carries the particle-axis position its layout spec recorded
        (``None`` for shared leaves)."""
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
        if args_shared:
            args_spec = const_spec(tr.args, None)
        else:
            args_spec = ((None,) + tuple(gen_spec(a, axis, n)
                                         for a in tr.args[1:])
                         if tr.args else ())
        return Trace(self, args_spec, None, axis, spec_inner)
