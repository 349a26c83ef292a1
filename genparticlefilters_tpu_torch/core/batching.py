"""Particle-axis specs, the per-particle interpretation and the batched-
layout guard (time-major layout).

Where the particle axis sits in each stored trace leaf is a layout choice
that every resampling gather has to know. Each generative function states
it through ``GenFn.trace_axes``: :class:`~.combinators.Unfold` keeps its
packed step storage time-major (``mat [T*R, N]``, particle axis 1) and its
active length ``t`` shared (spec ``None``); per-particle scores and carries
sit at axis 0. :func:`axes_spec` gathers those specs for a whole tree.

:func:`vmap_gfi` runs a per-particle program over the particle set with
``torch.func.vmap``: any body, including ones that index an event vector
positionally, reads right there. :func:`check_batched_layout` holds a
batched interpretation against the per-particle one, evaluated on fake
tensors (no kernel, no host read).

:func:`tree_take` and :func:`tree_put` gather and scatter a whole tree
along each leaf's particle axis (sub-state views, smc/state.py);
:func:`tree_concat` joins two trees along it (``pf_introduce``).
"""

from __future__ import annotations

import types
import weakref

import numpy as np
import torch

from .gfi import GenFn, Trace, batched_interpretation, ABSTRACT
from .packed import StorageLayout
from .tree import tree_map, tree_flatten, tree_unflatten, flatten_up_to

__all__ = ["axes_spec", "choice_axes", "vmap_gfi", "unbatch_avals",
           "tree_take", "tree_put", "tree_concat", "batch_size",
           "moveaxis_to_front", "check_batched_layout", "gen_spec",
           "const_spec", "spec_n", "flatten_with_axes", "perparticle_specs",
           "check_later", "BOUNDARY"]


_SPEC_PER_PARTICLE = []


class perparticle_specs:
    """Context: spec derivation runs on PER-PARTICLE trees (leaves lack the
    particle axis — a ``vmap_gfi`` output, or an Unfold's storage built
    inside one), so a leaf can host the axis at position ``ax`` whenever
    its rank is at least ``ax``; on batched trees (the default) the leaf
    must already CONTAIN the axis, anything under-ranked being shared."""

    def __enter__(self):
        _SPEC_PER_PARTICLE.append(True)
        return self

    def __exit__(self, *exc):
        _SPEC_PER_PARTICLE.pop()
        return False


def _leaf_axis(x, axis, n=None):
    """Shape-aware spec for one leaf: a leaf that cannot hold the particle
    axis at ``axis`` — rank too small, or (when the particle count ``n`` is
    known) the wrong extent there — is SHARED across particles (``None``).
    Non-tensor leaves (Python ints) are always shared. See
    :class:`perparticle_specs` for the per-particle rank rule."""
    if axis is None or x is None:
        return None
    if _SPEC_PER_PARTICLE:
        # a Python number a per-particle program returns is a 0-d value
        # there (JAX's map turns it into one): it gets the particle axis
        rank = x.dim() if isinstance(x, torch.Tensor) else (
            0 if isinstance(x, (bool, int, float)) else None)
        return axis if rank is not None and rank >= axis else None
    if not isinstance(x, torch.Tensor):
        return None
    if x.dim() <= axis:
        return None
    if n is not None and x.shape[axis] != n:
        return None
    return axis


def spec_n(score, axis):
    """The particle count implied by a trace's per-particle score leaf, or
    None when the score carries no particle axis (and on per-particle
    trees)."""
    if _SPEC_PER_PARTICLE:
        return None
    s = tuple(score.shape)
    return s[axis] if len(s) > axis else None


def const_spec(subtree, axis, n=None):
    """Spec tree with every leaf at ``axis`` (shape-aware, no Trace
    recursion)."""
    return tree_map(lambda x: _leaf_axis(x, axis, n), subtree)


def gen_spec(subtree, axis, n=None):
    """Spec for an arbitrary container: leaves at ``axis`` (shape-aware);
    nested traces defer to their generative function's ``trace_axes``."""
    return tree_map(
        lambda x: (x.gen_fn.trace_axes(x, axis) if isinstance(x, Trace)
                   else _leaf_axis(x, axis, n)),
        subtree, is_leaf=lambda x: isinstance(x, Trace))


def axes_spec(obj, axis: int = 0):
    """Per-leaf particle-axis spec for any tree that may contain traces.
    Top-level traces use the SMC convention that their args are one shared
    tuple (``args_shared=True``)."""
    return tree_map(
        lambda x: (x.gen_fn.trace_axes(x, axis, args_shared=True)
                   if isinstance(x, Trace) else axis),
        obj, is_leaf=lambda x: isinstance(x, Trace))


def choice_axes(gen_fn, tr: Trace):
    """Particle-axis position for every address of ``trace_choices(tr)``,
    as ``{address: int}`` (Unfold entries carry a leading time axis, so
    their particle axis is 1)."""
    return gen_fn.trace_choice_axes(tr, 0)


def batch_size(traces: Trace) -> int:
    """Number of particles in a batched trace (the score is always a
    per-particle scalar, so its leading axis is the particle count)."""
    return int(traces.score.shape[0])


def moveaxis_to_front(value, axis: int):
    """The particle axis of one tensor moved to position 0 (a view)."""
    return value if axis == 0 else torch.movedim(value, axis, 0)


def flatten_with_axes(tree):
    """(leaves, per-leaf particle axis, treedef) of any tree that may
    contain traces."""
    leaves, treedef = tree_flatten(tree)
    return leaves, flatten_up_to(treedef, axes_spec(tree)), treedef


def unbatch_avals(batched, spec, device="meta"):
    """Abstract per-particle values: each tensor leaf replaced by an empty
    tensor of its per-particle shape (the particle axis at its spec
    position dropped) on ``device`` — ``None`` keeps each leaf's device,
    for use under a ``FakeTensorMode``. Other leaves pass through."""
    leaves, td = tree_flatten(batched)
    out = []
    for x, ax in zip(leaves, flatten_up_to(td, spec)):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        shape = tuple(x.shape)
        if ax is not None and len(shape) > ax:
            shape = shape[:ax] + shape[ax + 1:]
        out.append(torch.empty(shape, dtype=x.dtype,
                               device=x.device if device is None else device))
    return tree_unflatten(td, out)


# ---------------------------------------------------------------------------
# Checks that read the device, deferred out of a per-particle map
# ---------------------------------------------------------------------------

_DEFERRED: list = []


def check_later(flag, on_set):
    """Call ``on_set()`` (which raises or warns) when ``flag`` is set.
    ``flag`` is a Python bool or a device bool. Inside a :func:`vmap_gfi`
    body a device flag cannot be read: it is carried out of the map, and
    read (any particle set) when the map returns."""
    if not isinstance(flag, torch.Tensor):
        if flag:
            on_set()
        return
    if _DEFERRED:
        _DEFERRED[-1].append((flag, on_set))
        return
    if bool(flag.any()):
        on_set()


# ---------------------------------------------------------------------------
# The per-particle interpretation
# ---------------------------------------------------------------------------

#: what :func:`vmap_gfi` copied at its output boundary (a mapped leaf that
#: leaves the map off its spec position, or unbatched, is made contiguous):
#: calls, tensors copied and bytes written
BOUNDARY = {"calls": 0, "copies": 0, "bytes": 0}


def _contains_trace(obj) -> bool:
    found = []
    tree_map(lambda x: found.append(isinstance(x, Trace)), obj,
             is_leaf=lambda x: isinstance(x, Trace))
    return any(found)


def _is_batched(x) -> bool:
    return (isinstance(x, torch.Tensor)
            and torch._C._functorch.is_batchedtensor(x))


def vmap_gfi(fn, *batched, in_specs=None, n=None, device="cuda"):
    """``fn`` run per particle over the particle axis of ``batched``: one
    ``torch.func.vmap`` (``randomness="different"``) with the enclosing
    batched interpretation suspended, so ``fn`` sees per-particle values.

    ``in_specs`` gives the particle-axis spec per argument (default: 0 for
    containers of tensors — e.g. per-particle constraints — and
    :func:`axes_spec` for traces); leaves with spec ``None`` are shared.
    With no mapped argument, ``n`` gives the particle count and
    ``device`` where the map runs (the card unless the caller asks for
    the CPU). Leaves that cannot leave a map (Python ints, static masks,
    tensors shared across particles) are carried out beside it: the map
    runs ``fn`` once, and Python control cannot branch on a mapped value,
    so they hold for every particle. Every mapped output lands at its
    :func:`axes_spec` position (derived on the per-particle tree,
    :class:`perparticle_specs`) as a contiguous tensor, so an Unfold's
    ``mat`` comes out ``[T*R, N]``. Checks ``fn`` defers with
    :func:`check_later` are read after the map."""
    if in_specs is None:
        in_specs = tuple(axes_spec(b) if _contains_trace(b)
                         else const_spec(b, 0) for b in batched)
    flat, mapped, in_dims, where = [], [], [], []
    for i, (b, s) in enumerate(zip(batched, in_specs)):
        leaves, td = tree_flatten(b)
        flat.append((leaves, td))
        for j, (x, ax) in enumerate(zip(leaves, flatten_up_to(td, s))):
            if (ax is not None and isinstance(x, torch.Tensor)
                    and x.dim() > ax):
                mapped.append(x)
                in_dims.append(ax)
                where.append((i, j))
    if not mapped:
        if n is None:
            raise ValueError("vmap_gfi: no argument carries a particle "
                             "axis; pass the particle count n")
        from ..utils.device import entry_device
        mapped.append(torch.empty((int(n), 0),
                                  device=entry_device(device, "vmap_gfi")))
        in_dims.append(0)
        where.append(None)
    out_device = mapped[0].device
    side = {}

    def per_particle(*xs):
        args = [list(leaves) for leaves, _ in flat]
        for x, w in zip(xs, where):
            if w is not None:
                args[w[0]][w[1]] = x
        args = [tree_unflatten(td, a) for a, (_, td) in zip(args, flat)]
        checks = []
        _DEFERRED.append(checks)
        try:
            with batched_interpretation(None):
                out = fn(*args)
        finally:
            _DEFERRED.pop()
        leaves, td = tree_flatten(out)
        with perparticle_specs():
            axes = flatten_up_to(td, axes_spec(out))
        outs, slots = [], []
        for x, ax in zip(leaves, axes):
            if ax is not None and isinstance(x, (bool, int, float)):
                x = torch.full((), x, device=out_device, dtype=(
                    torch.bool if isinstance(x, bool) else torch.int32
                    if isinstance(x, int) else torch.float32))
            if isinstance(x, torch.Tensor) and ax is not None:
                slots.append(("mapped", ax))
                outs.append(x)
                continue
            if _is_batched(x):
                raise ValueError(
                    f"vmap_gfi: an output leaf of shape {tuple(x.shape)} "
                    f"differs across particles where its layout keeps it "
                    f"shared (spec None)")
            slots.append(("shared", x))
        side["out"] = (td, slots, [on_set for _, on_set in checks])
        return tuple(outs) + tuple(torch.as_tensor(f) for f, _ in checks)

    res = torch.func.vmap(per_particle, in_dims=tuple(in_dims), out_dims=0,
                          randomness="different")(*mapped)
    td, slots, on_sets = side["out"]
    n_out = sum(1 for s in slots if s[0] == "mapped")
    outs, flags = res[:n_out], res[n_out:]
    BOUNDARY["calls"] += 1
    it = iter(outs)
    leaves = []
    for kind, v in slots:
        if kind == "shared":
            leaves.append(v)
            continue
        x = next(it)
        if v != 0:
            x = torch.movedim(x, 0, v)
        if not x.is_contiguous():
            x = x.contiguous()
            BOUNDARY["copies"] += 1
            BOUNDARY["bytes"] += x.numel() * x.element_size()
        leaves.append(x)
    for flag, on_set in zip(flags, on_sets):
        if bool(flag.any()):
            on_set()
    return tree_unflatten(td, leaves)


# ---------------------------------------------------------------------------
# The batched-layout guard
# ---------------------------------------------------------------------------

_GUARD_CACHE: dict = {}
_GUARD_CACHE_MAX = 1024


def layout_key(*parts):
    """A hashable key for the guard's cache: tensors and arrays by shape,
    dtype and device type, Python scalars by value, containers and tree
    nodes by structure, functions by code and closure, generative
    functions by what they run (a model rebuilt for every filter run keys
    as the same model), other objects by identity."""
    return tuple(_sig(p, 0) for p in parts)


_GF_SIGS = weakref.WeakKeyDictionary()


def _gf_sig(gf, depth):
    """A generative function's structural signature, computed once per
    object: its type, marker and attributes (the body's code and closure,
    an Unfold's step and horizon), not its counters."""
    sig = _GF_SIGS.get(gf)
    if sig is None:
        sig = (type(gf).__name__, bool(getattr(gf, "batch_safe", False))) + \
            tuple((k, _sig(v, depth + 1)) for k, v in sorted(vars(gf).items())
                  if k not in ("steps_run", "name", "batch_safe"))
        _GF_SIGS[gf] = sig
    return sig


def _sig(x, depth):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device.type)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   np.generic)):
        return x
    if isinstance(x, np.ndarray):
        return ("A", x.shape, x.dtype.str)
    if depth > 24:
        return ("O", id(x))
    if isinstance(x, StorageLayout):
        # the column treedef follows from the step function the enclosing
        # trace names; the specs say where each leaf lives
        return ("L", x.T, x.R, x.specs)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_sig(v, depth + 1) for v in x)
    if isinstance(x, dict):
        return ("D",) + tuple(sorted((repr(k), _sig(v, depth + 1))
                                     for k, v in x.items()))
    if isinstance(x, GenFn):
        return _gf_sig(x, depth)
    if hasattr(x, "tree_flatten") and hasattr(type(x), "tree_unflatten"):
        children, aux = x.tree_flatten()
        return (type(x).__name__, _sig(aux, depth + 1),
                tuple(_sig(c, depth + 1) for c in children))
    if isinstance(x, types.FunctionType):
        cells = tuple(_sig(c.cell_contents, depth + 1)
                      for c in (x.__closure__ or ()))
        return ("F", x.__code__, cells)
    if type(x).__module__.startswith(__package__.split(".")[0]):
        # this package's value objects: argdiffs, translators, transforms
        attrs = getattr(type(x), "__slots__", None) or sorted(vars(x))
        return (type(x).__name__,) + tuple(
            _sig(getattr(x, a, None), depth + 1) for a in attrs)
    return ("O", id(x))


def _canonical(tr):
    """The storage-free logical view of a trace: choice values by address,
    the retval and the score."""
    ch = tr.get_choices()
    return ({k: e.value for k, e in ch.entries.items()}, tr.get_retval(),
            tr.score)


def _shape(x):
    return (tuple(x.shape) if isinstance(x, torch.Tensor)
            else tuple(np.shape(x)))


def _fake_like(tree):
    """Every tensor leaf as an empty tensor of the same shape, dtype and
    device (fakes, under a ``FakeTensorMode``)."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device=x.device)
                    if isinstance(x, torch.Tensor) else x, tree)


def check_batched_layout(batched_tree, per_particle_fn, n: int,
                         context: str = "batched interpretation",
                         eval_args=(), eval_specs=None, key=None):
    """Guard against the batched-interpretation shape ambiguity (a value is
    per-particle iff its leading dim equals N): a genuinely shared array
    whose leading dim equals N is silently misread there. This evaluates
    ``per_particle_fn(*eval_args)`` — the SAME program, per-particle — on
    fake tensors (no kernel is launched and nothing is read from the
    device) and demands every leaf of ``batched_tree`` be exactly the
    per-particle leaf with one axis of extent ``n`` inserted at its
    particle-axis spec position (shared leaves: identical shapes).
    ``eval_args`` are batched trees, unbatched by ``eval_specs`` (default:
    :func:`axes_spec`) before the call. A pass is cached under ``key``
    (see :func:`layout_key`); a key seen before returns at once.

    Raises ``ValueError`` naming the first inconsistent leaf. Gate:
    ``config.check_batched_layout``."""
    if key is not None and key in _GUARD_CACHE:
        return
    from torch._subclasses.fake_tensor import FakeTensorMode
    if eval_specs is None:
        eval_specs = [axes_spec(a) for a in eval_args]
    b_sc_shape = tuple(batched_tree.score.shape)
    with FakeTensorMode(allow_non_fake_inputs=True):
        pp_args = [unbatch_avals(a, s, device=None)
                   for a, s in zip(eval_args, eval_specs)]
        # the checks the program would read are dropped (fakes hold no
        # values), and no step body it runs is counted
        _DEFERRED.append([])
        ABSTRACT.append(True)
        try:
            with batched_interpretation(None):
                pp = per_particle_fn(*pp_args)
        except (RuntimeError, IndexError, TypeError) as e:
            raise ValueError(
                f"{context}: the per-particle interpretation of this batched "
                f"call fails ({type(e).__name__}: {e}) — a value whose "
                f"leading dim equals the particle count n={n} was probably "
                f"misread as per-particle; to bypass, set "
                f"genparticlefilters_tpu_torch.config.check_batched_layout"
                f"=False.") from e
        finally:
            _DEFERRED.pop()
            ABSTRACT.pop()
        pp_ch, pp_rv, pp_sc = _canonical(pp)
        fake_b = _fake_like(batched_tree)
        b_ch, b_rv, _ = _canonical(fake_b)
        ch_ax = choice_axes(fake_b.gen_fn, fake_b)
        rv_spec = fake_b.gen_fn.retval_axes(fake_b)
    if set(pp_ch) != set(b_ch):
        raise ValueError(
            f"{context}: batched and per-particle interpretations produced "
            f"different choice ADDRESS SETS — a model value whose leading "
            f"dim equals the particle count n={n} was likely misread as "
            f"per-particle (see core/gfi.py batchedness convention). "
            f"Batched-only: {sorted(set(b_ch) - set(pp_ch), key=repr)}; "
            f"per-particle-only: {sorted(set(pp_ch) - set(b_ch), key=repr)}")
    items = [(f"choice {k}", _shape(b_ch[k]), _shape(pp_ch[k]),
              _leaf_axis(b_ch[k], ch_ax.get(k, 0), n)) for k in b_ch]
    b_rl, rtd = tree_flatten(b_rv)
    items += [(f"retval leaf {i}", _shape(bl), _shape(pl), ax)
              for i, (bl, pl, ax) in
              enumerate(zip(b_rl, flatten_up_to(rtd, pp_rv),
                            flatten_up_to(rtd, rv_spec)))]
    items.append(("score", b_sc_shape, _shape(pp_sc), 0))
    for name, bs, ps, ax in items:
        want = ps if ax is None else ps[:ax] + (n,) + ps[ax:]
        if bs != want:
            raise ValueError(
                f"{context}: {name} has batched shape {bs} but the "
                f"per-particle interpretation implies {want} "
                f"(per-particle shape {ps}, particle axis "
                f"{'shared' if ax is None else ax}, n={n}). A model value "
                f"whose leading dim coincidentally equals the particle "
                f"count was probably misread as per-particle — reshape it, "
                f"rename the axis, or pick a different particle count "
                f"(core/gfi.py batchedness convention); to bypass, set "
                f"genparticlefilters_tpu_torch.config.check_batched_layout"
                f"=False.")
    if key is not None:
        if len(_GUARD_CACHE) >= _GUARD_CACHE_MAX:
            _GUARD_CACHE.clear()
        _GUARD_CACHE[key] = True


# ---------------------------------------------------------------------------
# Axis-aware tree ops (gather / scatter / concat over the particle axis)
# ---------------------------------------------------------------------------

def _batched(leaf, ax) -> bool:
    return (ax is not None and isinstance(leaf, torch.Tensor)
            and leaf.dim() > ax)


def tree_take(tree, idx):
    """Gather ``leaf[..., idx, ...]`` along each leaf's particle axis.
    Leaves shared across particles pass through untouched."""
    leaves, axes, treedef = flatten_with_axes(tree)
    idx = torch.as_tensor(idx).long()
    return tree_unflatten(treedef, [
        torch.index_select(l, ax, idx.to(l.device)) if _batched(l, ax) else l
        for l, ax in zip(leaves, axes)])


def tree_put(full, block, idx):
    """``full`` with ``block`` written at particle indices ``idx`` along
    each leaf's particle axis, out of place: ``full`` is not modified."""
    leaves, axes, treedef = flatten_with_axes(full)
    blocks = tree_flatten(block)[0]
    if len(blocks) != len(leaves):
        raise ValueError("tree_put: block and full differ in structure")
    idx = torch.as_tensor(idx).long()
    return tree_unflatten(treedef, [
        f.index_copy(ax, idx.to(f.device), b) if _batched(f, ax) else f
        for f, ax, b in zip(leaves, axes, blocks)])


def tree_concat(a, b):
    """Concatenate two batched trees of the same structure along each
    leaf's particle axis (the axes of ``a``). Leaves shared across
    particles keep ``a``'s value."""
    leaves, axes, treedef = flatten_with_axes(a)
    others = tree_flatten(b)[0]
    if len(others) != len(leaves):
        raise ValueError("tree_concat: the trees differ in structure")
    return tree_unflatten(treedef, [
        torch.cat([x, y], dim=ax) if _batched(x, ax) else x
        for x, ax, y in zip(leaves, axes, others)])
