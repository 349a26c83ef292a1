"""The Generative Function Interface on tensors: traces, the ``@gen`` DSL
and its batched interpreters.

A trace is a plain object holding ``(gen_fn, args, retval, score, inner)``;
``inner`` holds the choices. Models are written with :func:`gen`, and
random choices are made with ``trace(addr, dist)``, which dispatches to the
interpreter on top of a Python handler stack.

Weight semantics (Gen's GFI contract):

- ``generate``:   weight = Σ log p(constrained choices | rest)
- ``update``:     weight = score_new − score_old − Σ log q(freshly sampled)
- ``regenerate``: weight = (score_new − Σ_sel lp_new) − (score_old − Σ_sel lp_old)

A body calls another generative function with ``trace(addr, gen_fn,
args)``: each interpreter runs the callee's own verb on the constraints,
selection or old sub-trace scoped under ``addr`` and records the
sub-trace under ``inner["subs"]``.

Batched interpretation (:class:`batched_interpretation`) runs ONE
interpretation with ``[batch]``-leading site values: a value is
per-particle iff its leading dimension equals the batch size, anything
else is shared across particles. Where the JAX package takes a PRNG key,
the verbs here take a ``torch.Generator``; sites draw from it in order.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .choicemap import (ChoiceMap, Entry, Selection, EMPTY, normalize_address,
                        value_on)
from .distributions import Distribution
from .tree import tree_map

__all__ = [
    "Trace", "GenFn", "DynamicGenFn", "gen", "trace",
    "NoChange", "UnknownChange", "Extend", "batched_interpretation",
    "current_batch", "simulate", "generate", "propose", "assess", "update",
    "regenerate", "get_choices", "get_args", "get_retval", "get_score",
    "get_gen_fn",
]


# ---------------------------------------------------------------------------
# Argdiffs
# ---------------------------------------------------------------------------

class NoChange:
    def __repr__(self):
        return "NoChange()"


class UnknownChange:
    def __repr__(self):
        return "UnknownChange()"


class Extend:
    """Argdiff for a combinator length argument: a promise that the new
    length equals the old plus ``k`` and that constraints only target the
    newly activated steps. It selects the O(k) extension path of
    :class:`~.combinators.Unfold`.

    When the Unfold is called inside a wrapping ``@gen`` model, name it:
    ``Extend(1, at="line")`` reaches exactly that sub-call (the others are
    updated by their full interpreters). A bare ``Extend(k)`` reaches the
    sub-call of a model that makes exactly one."""

    __slots__ = ("k", "at")

    def __init__(self, k: int = 1, at=None):
        self.k = int(k)
        self.at = at

    def __repr__(self):
        return (f"Extend({self.k})" if self.at is None
                else f"Extend({self.k}, at={self.at!r})")


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------

class Trace:
    """An execution record: gen_fn, args, retval, score and a
    gen_fn-specific ``inner`` payload holding the choices."""

    __slots__ = ("gen_fn", "args", "retval", "score", "inner")

    def __init__(self, gen_fn, args, retval, score, inner):
        self.gen_fn = gen_fn
        self.args = args
        self.retval = retval
        self.score = score
        self.inner = inner

    # tree protocol (core/tree.py): the gen_fn is static structure
    def tree_flatten(self):
        return (self.args, self.retval, self.score, self.inner), self.gen_fn

    @classmethod
    def tree_unflatten(cls, gen_fn, children):
        return cls(gen_fn, *children)

    def get_choices(self) -> ChoiceMap:
        return self.gen_fn.trace_choices(self)

    def get_args(self):
        return self.args

    def get_retval(self):
        return self.gen_fn.trace_retval(self)

    def get_score(self):
        return self.score

    def get_gen_fn(self):
        return self.gen_fn

    def __getitem__(self, addr):
        """A choice value by (possibly hierarchical) address."""
        return self.get_choices()[addr]


# ---------------------------------------------------------------------------
# GenFn base
# ---------------------------------------------------------------------------

class GenFn:
    """Base class for generative functions."""

    #: opt-in marker for batched interpretation: True only when the body is
    #: batch-polymorphic (every value may carry a leading particle axis)
    batch_safe: bool = False

    def simulate(self, gen, args) -> Trace:
        raise NotImplementedError

    def generate(self, gen, args, constraints: ChoiceMap = EMPTY):
        raise NotImplementedError

    def propose(self, gen, args):
        """``(choices, score, retval)`` of a fresh simulation."""
        tr = self.simulate(gen, args)
        return tr.get_choices(), tr.score, tr.get_retval()

    def assess(self, args, choices: ChoiceMap):
        raise NotImplementedError

    def update(self, gen, tr: Trace, new_args, argdiffs,
               constraints: ChoiceMap):
        new_tr, logq, discard = self._update(gen, tr, new_args, constraints,
                                             argdiffs=argdiffs)
        weight = new_tr.score - tr.score - logq
        return new_tr, weight, UnknownChange(), discard

    def regenerate(self, gen, tr: Trace, new_args, argdiffs,
                   selection: Selection, window: int | None = None):
        new_tr, sel_new, sel_old = self._regenerate(
            gen, tr, new_args, selection, window=window)
        weight = (new_tr.score - sel_new) - (tr.score - sel_old)
        return new_tr, weight

    def regenerate_delta(self, gen, tr: Trace, new_args, argdiffs,
                         selection: Selection, window: int | None = None):
        """Like :meth:`regenerate`, but returns ``(delta, weight)``, the
        delta applied later by :meth:`apply_regenerate_delta` under an
        accept mask. Default delta: the full new trace."""
        return self.regenerate(gen, tr, new_args, argdiffs, selection,
                               window=window)

    def apply_regenerate_delta(self, tr: Trace, delta, accept):
        """The accepted-or-original trace from a regenerate delta. Default:
        :meth:`select_trace` between the two full traces."""
        return self.select_trace(accept, delta, tr)

    def select_trace(self, accept, new_tr: Trace, old_tr: Trace) -> Trace:
        """``where(accept, new, old)`` over two traces of this gen fn. The
        stored args pass through from ``new_tr`` unselected: accept/reject
        kernels never change args, and selecting them would give a
        particle axis to values the layout keeps shared."""
        return Trace(self, new_tr.args,
                     select_batched(accept, new_tr.retval, old_tr.retval),
                     select_batched(accept, new_tr.score, old_tr.score),
                     select_batched(accept, new_tr.inner, old_tr.inner))

    # -- internal protocol (used by combinators) --------------------------
    def _update(self, gen, tr, new_args, constraints, argdiffs=None):
        """Returns (new_trace, logq_fresh, discard)."""
        raise NotImplementedError

    def _regenerate(self, gen, tr, new_args, selection, window=None,
                    old_args=None, need_sel_old=True):
        """Returns (new_trace, sel_lp_new, sel_lp_old)."""
        raise NotImplementedError

    def _sel_logp(self, tr, args, selection, window=None):
        """Force-execute with the old trace's values under ``args``; returns
        ``(retval, Σ selected∧present site log-probs, Σ all present site
        log-probs)``."""
        raise NotImplementedError

    # -- structure --------------------------------------------------------
    def trace_retval(self, tr: Trace):
        return tr.retval

    def retval_axes(self, tr: Trace, axis: int = 0):
        """Particle-axis spec of the materialized ``get_retval()``."""
        return self.trace_axes(tr, axis).retval

    def trace_choices(self, tr: Trace) -> ChoiceMap:
        raise NotImplementedError

    def mask_trace(self, tr: Trace, m) -> Trace:
        """AND every choice's presence mask with ``m``."""
        raise NotImplementedError

    def batch_stored_args(self, tr: Trace, batch: int) -> Trace:
        """This trace with its STORED args broadcast to the per-particle
        layout :meth:`trace_axes` gives args at a sub-call position
        (batched interpretation only; see ``_Handler.record_sub``)."""
        return Trace(self, _batch_tree(tr.args, batch, tr.score.device),
                     tr.retval, tr.score, tr.inner)

    def trace_axes(self, tr: Trace, axis: int = 0,
                   args_shared: bool = False):
        """Particle-axis spec for this trace stacked across particles: the
        same structure as ``tr``, each leaf an int axis or ``None`` for
        values shared across particles (see core/batching.py)."""
        from .batching import gen_spec, const_spec, spec_n
        n = spec_n(tr.score, axis)
        args_spec = (const_spec(tr.args, None) if args_shared
                     else gen_spec(tr.args, axis, n))
        return Trace(self, args_spec, gen_spec(tr.retval, axis, n), axis,
                     gen_spec(tr.inner, axis, n))

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        """``{address: particle-axis}`` for every entry of the choices."""
        return {k: axis for k in self.trace_choices(tr).entries}

    def __call__(self, *args):
        raise TypeError("inside a @gen body, call a generative function "
                        "with trace(addr, gen_fn, args)")


def _where_lead(cond, a, b):
    """``where`` aligning a per-particle ``[b]`` ``cond`` against the
    LEADING axes of the operands (a 0-d cond, the per-particle path, passes
    through). Operands with fewer axes than ``cond`` are shared across
    particles: a select over a shared leaf is reached only where both
    sides hold the same kept value, so it passes ``a`` through."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    nd = max(a.dim(), b.dim())
    if cond.dim() > nd:
        return a
    c = cond.reshape(tuple(cond.shape) + (1,) * (nd - cond.dim()))
    return torch.where(c, a.to(b.dtype), b)


def select_batched(accept, new, old):
    """``where(accept, new, old)`` over a container, dispatching nested
    traces to :meth:`GenFn.select_trace` and keeping leaves that are the
    same object (or equal Python values) on both sides unselected, so they
    keep their layout. ``accept`` is a device bool: ``[b]`` under a
    batched interpretation, 0-d per particle."""
    def one(a, b):
        if isinstance(a, Trace):
            return a.gen_fn.select_trace(accept, a, b)
        if a is b or not (isinstance(a, torch.Tensor)
                          or isinstance(b, torch.Tensor)) and a == b:
            return a
        return _where_lead(accept, a, b)
    return tree_map(one, new, old, is_leaf=lambda x: isinstance(x, Trace))


# ---------------------------------------------------------------------------
# Handler machinery for the @gen DSL
# ---------------------------------------------------------------------------

_HANDLER_STACK = []
_BATCH_STACK: list = []


class batched_interpretation:
    """Context manager: run interpreters in BATCHED mode over ``batch``
    particles — one interpretation with [batch]-leading site values.

    Batchedness convention: a value or distribution parameter carries the
    particle axis iff its leading dim equals ``batch``; anything else is
    shared. A genuinely shared array whose leading dim equals the particle
    count is indistinguishable — avoid such shapes in batched models."""

    def __init__(self, batch):
        self.batch = None if batch is None else int(batch)

    def __enter__(self):
        _BATCH_STACK.append(self.batch)
        return self.batch

    def __exit__(self, *exc):
        _BATCH_STACK.pop()
        return False


def current_batch():
    """The active batched-interpretation size, or None (per-particle)."""
    return _BATCH_STACK[-1] if _BATCH_STACK else None


def _bsum(x, batch):
    """Reduce a site log-prob into a handler accumulator: Σ over event dims
    keeping the leading particle axis in batched mode; shared values reduce
    to a scalar, which broadcasts into the [batch] accumulator."""
    x = torch.as_tensor(x)
    if batch is not None and x.dim() >= 1 and x.shape[0] == batch:
        return x if x.dim() == 1 else x.reshape(batch, -1).sum(dim=1)
    return x.sum()


def _to_batch(v, batch, device):
    """``v`` with a leading particle axis in batched mode: values shared
    across particles broadcast (host values are placed on ``device`` by
    :func:`value_on`); values whose leading dim is ``batch`` pass."""
    if batch is None:
        return v
    if not isinstance(v, torch.Tensor):
        v = value_on(v, device)
    if v.dim() >= 1 and v.shape[0] == batch:
        return v
    return v.expand((batch,) + tuple(v.shape))


def _batch_tree(x, batch, device):
    """:func:`_to_batch` over a container, leaving nested traces alone
    (their leaves follow their own batched layout)."""
    if batch is None:
        return x
    return tree_map(
        lambda l: l if isinstance(l, Trace) else _to_batch(l, batch, device),
        x, is_leaf=lambda l: isinstance(l, Trace))


def trace(addr, dist_or_gf, args=None):
    """Make a random choice at ``addr`` inside a ``@gen`` function body:
    ``trace("x", normal(0., 1.))`` samples a distribution,
    ``trace("sub", other_gen_fn, (a, b))`` calls a generative function."""
    if not _HANDLER_STACK:
        raise RuntimeError(
            "trace() called outside of a generative-function interpreter; "
            "models must be run via generate/update/regenerate")
    h = _HANDLER_STACK[-1]
    key = normalize_address(addr)
    if isinstance(dist_or_gf, Distribution):
        return h.dist_site(key, dist_or_gf)
    return h.call_site(key, dist_or_gf,
                       tuple(args) if args is not None else ())


def _masked_sum(lp, m, batch=None):
    """Σ lp over set mask bits; NaN/Inf-safe (masked slots contribute 0)."""
    if m is True:
        return _bsum(lp, batch)
    if m is False:
        return torch.zeros((), dtype=torch.float32, device=lp.device)
    shp = torch.broadcast_shapes(lp.shape, m.shape)
    return _bsum(torch.where(m.expand(shp), lp.expand(shp),
                             torch.zeros((), dtype=lp.dtype,
                                         device=lp.device)), batch)


def _broadcast_val(value, like):
    v = value_on(value, like.device)
    if v.dtype != like.dtype:
        v = v.to(like.dtype)
    return v.expand(like.shape)


def _mask_to(m, like_shape):
    """A presence/selection mask aligned against the LEADING axes of a
    value of shape ``like_shape`` (static True/False pass through)."""
    if m is True or m is False:
        return m
    mb = m.to(torch.bool)
    extra = len(like_shape) - mb.dim()
    if extra > 0:
        mb = mb.reshape(tuple(mb.shape) + (1,) * extra)
    return mb.expand(like_shape)


def _and_masks(a, b):
    if a is True:
        return b
    if b is True:
        return a
    if a is False or b is False:
        return False
    return torch.logical_and(a, b)


def _not_mask(m):
    if m is True:
        return False
    if m is False:
        return True
    return torch.logical_not(m)


class _Handler:
    """Shared accumulator state for the interpreters of the DSL. In batched
    mode every accumulator is a per-particle [batch] vector."""

    def __init__(self, gen, device):
        self.gen = gen
        self.device = torch.device(device)
        self.batch = current_batch()
        self.sites: Dict[Tuple, Entry] = {}
        self.subs: Dict[Tuple, Trace] = {}
        self.score = self._zero()

    def _zero(self):
        shape = () if self.batch is None else (self.batch,)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def sample_site(self, dist):
        if self.gen is None:
            raise RuntimeError("this interpreter does not sample; a site "
                               "required sampling but no generator was "
                               "provided")
        if self.batch is None:
            return dist.sample(self.gen)
        return dist.sample_batched(self.gen, self.batch)

    def _check_new(self, addr):
        if addr in self.sites or addr in self.subs:
            raise ValueError(f"duplicate address {addr!r} in @gen function")

    def record(self, addr, value, lp):
        self._check_new(addr)
        self.sites[addr] = Entry(value, True)
        self.score = self.score + _bsum(lp, self.batch)

    def record_sub(self, addr, sub_tr: Trace):
        self._check_new(addr)
        if self.batch is not None:
            # stored args of a sub-call sit at per-particle spec positions
            # (GenFn.trace_axes): shared leaves get the particle axis (an
            # Unfold keeps its lockstep length shared)
            sub_tr = sub_tr.gen_fn.batch_stored_args(sub_tr, self.batch)
        self.subs[addr] = sub_tr
        self.score = self.score + _bsum(sub_tr.score, self.batch)

    def inner(self):
        return {"sites": self.sites, "subs": self.subs}


class _SimulateHandler(_Handler):
    def dist_site(self, addr, dist):
        v = self.sample_site(dist)
        self.record(addr, v, dist.log_prob(v))
        return v

    def call_site(self, addr, gf, args):
        sub = gf.simulate(self.gen, args)
        self.record_sub(addr, sub)
        return sub.get_retval()


class _GenerateHandler(_Handler):
    def __init__(self, gen, constraints: ChoiceMap, device):
        super().__init__(gen, device)
        self.constraints = constraints
        self.weight = self._zero()

    def dist_site(self, addr, dist):
        e = self.constraints.resolve(addr)
        if e is None:
            v = self.sample_site(dist)
            self.record(addr, v, dist.log_prob(v))
            return v
        if e.mask is True:
            # fully-constrained site: store the SHARED value (no particle
            # axis, no sampling)
            v = value_on(e.value, self.device)
            lp = dist.log_prob(v)
            self.weight = self.weight + _bsum(lp, self.batch)
            self.record(addr, v, lp)
            return v
        sampled = self.sample_site(dist)
        m = _mask_to(e.mask, sampled.shape)
        v = torch.where(m, _broadcast_val(e.value, sampled), sampled)
        lp = dist.log_prob(v)
        self.weight = self.weight + _masked_sum(lp, m, self.batch)
        self.record(addr, v, lp)
        return v

    def call_site(self, addr, gf, args):
        sub, w = gf.generate(self.gen, args,
                             _scope_path(self.constraints, addr))
        self.weight = self.weight + w
        self.record_sub(addr, sub)
        return sub.get_retval()


class _AssessHandler(_Handler):
    """Score given choices: every site must be in ``choices``."""

    def __init__(self, choices: ChoiceMap, device):
        super().__init__(None, device)
        self.choices = choices

    def dist_site(self, addr, dist):
        e = self.choices.resolve(addr)
        if e is None:
            raise ValueError(f"assess: missing choice at address {addr!r}")
        v = value_on(e.value, self.device)
        self.record(addr, v, dist.log_prob(v))
        return v

    def call_site(self, addr, gf, args):
        retval, score = gf.assess(args, _scope_path(self.choices, addr))
        self._check_new(addr)
        self.score = self.score + score
        return retval


class _UpdateHandler(_Handler):
    def __init__(self, gen, old_inner, constraints: ChoiceMap, device,
                 argdiffs=None, sole_subcall=False):
        super().__init__(gen, device)
        self.old_sites = old_inner["sites"]
        self.old_subs = old_inner["subs"]
        self.constraints = constraints
        self.argdiffs = argdiffs
        self.sole_subcall = sole_subcall
        self.logq = self._zero()
        self.discard: Dict[Tuple, Entry] = {}

    def dist_site(self, addr, dist):
        e = self.constraints.resolve(addr)
        old = self.old_sites.get(addr)

        # static fast paths — no sampling, SHARED storage preserved
        if e is not None and e.mask is True:
            v = value_on(e.value, self.device)
            if old is not None and old.mask is not False:
                self.discard[addr] = Entry(old.value, old.mask)
            self.record(addr, v, dist.log_prob(v))
            return v
        if e is None and old is not None and old.mask is True:
            v = old.value
            self.record(addr, v, dist.log_prob(v))
            return v

        sampled = self.sample_site(dist)
        shape = sampled.shape
        mc = False if e is None else _mask_to(e.mask, shape)
        mo = False if old is None else _mask_to(old.mask, shape)

        # value priority: constraint > old > fresh
        v = sampled
        if mo is not False:
            ov = _broadcast_val(old.value, sampled)
            v = ov if mo is True else torch.where(mo, ov, v)
        if mc is not False:
            cv = _broadcast_val(e.value, sampled)
            v = cv if mc is True else torch.where(mc, cv, v)

        lp = dist.log_prob(v)
        fresh = _and_masks(_not_mask(mc), _not_mask(mo))
        if fresh is not False:
            self.logq = self.logq + _masked_sum(lp, fresh, self.batch)
        overwritten = _and_masks(mc, mo)
        if overwritten is not False and old is not None:
            self.discard[addr] = Entry(old.value, overwritten)
        self.record(addr, v, lp)
        return v

    def _sub_argdiffs(self, addr, n_args):
        """The argdiffs a sub-call receives: an ``Extend`` promise reaches
        only the sub-call it names (``Extend(k, at=addr)``), or the sole
        sub-call of a model that makes one; every other sub-call is
        updated by its full interpreter."""
        if not self.argdiffs or not isinstance(self.argdiffs[0], Extend):
            return None
        ext = self.argdiffs[0]
        if ext.at is not None:
            if normalize_address(ext.at) != addr:
                return None
        elif not self.sole_subcall:
            return None
        return (ext,) + tuple(NoChange() for _ in range(max(n_args - 1, 0)))

    def call_site(self, addr, gf, args):
        scoped = _scope_path(self.constraints, addr)
        old_sub = self.old_subs.get(addr)
        if old_sub is None:
            # a fresh sub-call: everything it did not constrain was sampled
            sub, w = gf.generate(self.gen, args, scoped)
            self.logq = self.logq + (sub.score - w)
            self.record_sub(addr, sub)
            return sub.get_retval()
        sub, logq, disc = gf._update(
            self.gen, old_sub, args, scoped,
            argdiffs=self._sub_argdiffs(addr, len(args)))
        self.logq = self.logq + logq
        for k, e in disc.entries.items():
            self.discard[addr + k] = e
        self.record_sub(addr, sub)
        return sub.get_retval()


class _RegenerateHandler(_Handler):
    def __init__(self, gen, old_inner, selection: Selection, device,
                 window=None):
        super().__init__(gen, device)
        self.old_sites = old_inner["sites"]
        self.old_subs = old_inner["subs"]
        self.selection = selection
        self.window = window
        self.sel_new = self._zero()

    def dist_site(self, addr, dist):
        old = self.old_sites.get(addr)
        sel = _scope_path(self.selection, addr).mask_at_leaf()
        if old is not None and sel is False and old.mask is True:
            # statically unselected, fully present: keep the old value
            v = old.value
            self.record(addr, v, dist.log_prob(v))
            return v
        sampled = self.sample_site(dist)
        shape = sampled.shape
        if old is None:
            # structurally new site: fresh in both the new score and
            # sel_new, cancelling in the weight
            lp = dist.log_prob(sampled)
            self.sel_new = self.sel_new + _bsum(lp, self.batch)
            self.record(addr, sampled, lp)
            return sampled
        mo = _mask_to(old.mask, shape)
        ms = _mask_to(sel, shape)
        ov = _broadcast_val(old.value, sampled)
        # selected (or old-absent) slots are resampled
        resample = _not_mask(_and_masks(mo, _not_mask(ms)))
        if resample is False:
            v = ov
        elif resample is True:
            v = sampled
        else:
            v = torch.where(resample, sampled, ov)
        lp = dist.log_prob(v)
        if resample is not False:
            self.sel_new = self.sel_new + _masked_sum(lp, resample,
                                                      self.batch)
        self.record(addr, v, lp)
        return v

    def call_site(self, addr, gf, args):
        old_sub = self.old_subs.get(addr)
        if old_sub is None:
            # structurally new sub-call: fresh in both the new score and
            # sel_new, cancelling in the weight
            sub = gf.simulate(self.gen, args)
            self.sel_new = self.sel_new + _bsum(sub.score, self.batch)
            self.record_sub(addr, sub)
            return sub.get_retval()
        # the sub-tree's sel_old is not taken from here: the enclosing
        # _sel_logp pass recomputes it under the OLD upstream values (the
        # sub-call's own fallback would score it under the new args)
        sub, sn, _ = gf._regenerate(self.gen, old_sub, args,
                                    _scope_path(self.selection, addr),
                                    window=self.window, need_sel_old=False)
        self.sel_new = self.sel_new + sn
        self.record_sub(addr, sub)
        return sub.get_retval()


class _SelLogpHandler(_Handler):
    """Re-execute a body FORCING the old trace's stored values, accumulating
    the selection-masked old log-probs (regenerate's ``sel_old`` term) and
    the total old score. Never samples from the caller's generator."""

    def __init__(self, old_inner, selection: Selection, device, window=None):
        super().__init__(None, device)
        self.old_sites = old_inner["sites"]
        self.old_subs = old_inner["subs"]
        self.selection = selection
        self.window = window
        self.sel_old = self._zero()
        self._dummy = None

    def _dummy_gen(self):
        """A fixed local generator for the placeholder values of sites the
        old trace lacks: the caller's generator is never consumed here."""
        if self._dummy is None:
            self._dummy = torch.Generator(device=self.device).manual_seed(0)
        return self._dummy

    def dist_site(self, addr, dist):
        old = self.old_sites.get(addr)
        if old is None:
            # structurally new site (absent from the old trace): it adds
            # nothing to the old score or sel_old; a placeholder value lets
            # the body run on
            if self.batch is None:
                return dist.sample(self._dummy_gen())
            return dist.sample_batched(self._dummy_gen(), self.batch)
        v = old.value
        mo = _mask_to(old.mask, v.shape)
        if mo is False:
            return v
        lp = dist.log_prob(v)
        self.score = self.score + _masked_sum(lp, mo, self.batch)
        sel = _scope_path(self.selection, addr).mask_at_leaf()
        m = _and_masks(_mask_to(sel, v.shape), mo)
        if m is not False:
            self.sel_old = self.sel_old + _masked_sum(lp, m, self.batch)
        return v

    def call_site(self, addr, gf, args):
        old_sub = self.old_subs.get(addr)
        if old_sub is None:
            # structurally new sub-call: no contribution (see dist_site)
            return gf.simulate(self._dummy_gen(), args).get_retval()
        retval, so, sc = gf._sel_logp(old_sub, args,
                                      _scope_path(self.selection, addr),
                                      window=self.window)
        self.sel_old = self.sel_old + so
        self.score = self.score + sc
        return retval


def _scope_path(sel, path):
    out = sel
    for comp in path:
        out = out.scope(comp)
    return out


def _trace_device(tr: Trace):
    return tr.score.device


def _assess_device(args, choices: ChoiceMap):
    """The device ``assess`` scores on: that of the first tensor (or
    trace) among ``args``, else of the first tensor value in ``choices``.
    Host values in ``choices`` (Python and numpy) name no device, so with
    nothing else to go by this raises rather than choose the CPU."""
    def first(xs):
        for x in xs:
            if isinstance(x, Trace):
                return _trace_device(x)
            if isinstance(x, torch.Tensor):
                return x.device
            if isinstance(x, (tuple, list)):
                d = first(x)
                if d is not None:
                    return d
            elif isinstance(x, dict):
                d = first(x.values())
                if d is not None:
                    return d
        return None
    device = first(args)
    if device is None:
        device = first(e.value for e in choices.entries.values())
    if device is None:
        raise ValueError("assess: neither the args nor the choices hold a "
                         "tensor to take the device from; pass the choices "
                         "or an argument as a tensor on the run's device")
    return device


# ---------------------------------------------------------------------------
# DynamicGenFn — the @gen DSL
# ---------------------------------------------------------------------------

class DynamicGenFn(GenFn):
    """A generative function defined by a Python body using :func:`trace`.
    The address set must be the same on every execution."""

    def __init__(self, fn: Callable, name: str | None = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "gen_fn")

    def __repr__(self):
        return f"@gen {self.name}"

    def _run(self, handler, args):
        _HANDLER_STACK.append(handler)
        try:
            retval = self.fn(*args)
        finally:
            _HANDLER_STACK.pop()
        return retval

    def _mk_trace(self, args, retval, h: _Handler):
        return Trace(self, args, retval, h.score, h.inner())

    def simulate(self, gen, args):
        h = _SimulateHandler(gen, gen.device)
        retval = self._run(h, args)
        return self._mk_trace(args, retval, h)

    def generate(self, gen, args, constraints: ChoiceMap = EMPTY):
        h = _GenerateHandler(gen, constraints, gen.device)
        retval = self._run(h, args)
        return self._mk_trace(args, retval, h), h.weight

    def assess(self, args, choices: ChoiceMap):
        """``(retval, score)`` of the body run on ``choices``, on the
        device of the args (see :func:`_assess_device`)."""
        h = _AssessHandler(choices, _assess_device(args, choices))
        retval = self._run(h, args)
        return retval, h.score

    def _update(self, gen, tr: Trace, new_args, constraints: ChoiceMap,
                argdiffs=None):
        h = _UpdateHandler(gen, tr.inner, constraints, _trace_device(tr),
                           argdiffs=argdiffs,
                           sole_subcall=len(tr.inner["subs"]) == 1)
        retval = self._run(h, new_args)
        return (self._mk_trace(new_args, retval, h), h.logq,
                ChoiceMap(h.discard))

    def _regenerate(self, gen, tr: Trace, new_args, selection: Selection,
                    window=None, old_args=None, need_sel_old=True):
        h = _RegenerateHandler(gen, tr.inner, selection, _trace_device(tr),
                               window=window)
        retval = self._run(h, new_args)
        if not need_sel_old:
            sel_old = torch.zeros((), dtype=torch.float32,
                                  device=_trace_device(tr))
        else:
            if old_args is None:
                old_args = tr.args if tr.args else new_args
            _, sel_old, _ = self._sel_logp(tr, old_args, selection,
                                           window=window)
        return self._mk_trace(new_args, retval, h), h.sel_new, sel_old

    def _sel_logp(self, tr: Trace, args, selection: Selection, window=None):
        h = _SelLogpHandler(tr.inner, selection, _trace_device(tr),
                            window=window)
        retval = self._run(h, args)
        return retval, h.sel_old, h.score

    # -- structure --------------------------------------------------------
    def trace_choices(self, tr: Trace) -> ChoiceMap:
        out: Dict[Tuple, Entry] = dict(tr.inner["sites"])
        for addr, sub in tr.inner["subs"].items():
            for k, e in sub.get_choices().entries.items():
                out[addr + k] = e
        return ChoiceMap(out)

    def mask_trace(self, tr: Trace, m) -> Trace:
        sites = {a: Entry(e.value, _and_masks(e.mask, m))
                 for a, e in tr.inner["sites"].items()}
        subs = {a: s.gen_fn.mask_trace(s, m)
                for a, s in tr.inner["subs"].items()}
        return Trace(tr.gen_fn, tr.args, tr.retval, tr.score,
                     {"sites": sites, "subs": subs})

    def trace_choice_axes(self, tr: Trace, axis: int = 0):
        out = {a: axis for a in tr.inner["sites"]}
        for addr, sub in tr.inner["subs"].items():
            for k, ax in sub.gen_fn.trace_choice_axes(sub, axis).items():
                out[addr + k] = ax
        return out


def gen(fn: Callable) -> DynamicGenFn:
    """Decorator: turn a Python function using :func:`trace` into a
    generative function (Gen's ``@gen``)."""
    return DynamicGenFn(fn)


# ---------------------------------------------------------------------------
# Module-level GFI verbs (Gen-style free functions)
# ---------------------------------------------------------------------------

def simulate(gf: GenFn, gen, args):
    return gf.simulate(gen, args)


def generate(gf: GenFn, gen, args, constraints: ChoiceMap = EMPTY):
    return gf.generate(gen, args, constraints)


def propose(gf: GenFn, gen, args):
    return gf.propose(gen, args)


def assess(gf: GenFn, args, choices: ChoiceMap):
    return gf.assess(args, choices)


def update(gen, tr: Trace, new_args, argdiffs, constraints: ChoiceMap):
    return tr.gen_fn.update(gen, tr, new_args, argdiffs, constraints)


def regenerate(gen, tr: Trace, new_args, argdiffs, selection: Selection,
               window: int | None = None):
    return tr.gen_fn.regenerate(gen, tr, new_args, argdiffs, selection,
                                window=window)


def get_choices(tr: Trace):
    return tr.get_choices()


def get_args(tr: Trace):
    return tr.get_args()


def get_retval(tr: Trace):
    return tr.get_retval()


def get_score(tr: Trace):
    return tr.get_score()


def get_gen_fn(tr: Trace):
    return tr.get_gen_fn()
