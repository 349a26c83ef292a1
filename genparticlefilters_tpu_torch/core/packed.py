"""Packed time-major step storage for :class:`~.combinators.Unfold` traces.

Every per-step per-particle 4-byte leaf of an Unfold's stacked storage —
site values and the stacked retval carries — lives in ONE int32 matrix
``mat [T*R, N]`` (``R`` rows per step, particles along the minor axis).
Trace extension writes one contiguous ``[k*R, N]`` slab, and the
resampling gather moves ``mat`` as a single piece whose gathered output is
the new ``mat``.

Stacked leaves that cannot pack stay ordinary leaves in ``extras``:
values shared across particles (fully-constrained observation sites),
and dtypes outside {float32, int32, bool}. Zero-size leaves keep only a
spec. float32 rows are bit patterns (``view(torch.int32)``), bool rows
are 0/1. A Python number in a step's column — the active length of an
Unfold called inside the step — is host metadata: its extra is a
:class:`StaticColumn` of one value per step, with no device column, so
writing it reads nothing from the device.

The same :class:`StorageLayout` describes the batched form (``mat [T*R,
N]``) and the per-particle form inside a ``vmap_gfi`` map (``mat
[T*R]``); ``mat.dim()`` says which an instance is in, so mapping the
particle axis at ``mat`` axis 1 turns one into the other. Writes are
copy-on-write: every writer returns a storage with new tensors and leaves
its input untouched, except where the store is the writer's own
(:func:`owned`: a trace the caller donates, or an empty trace the writer
built itself), which :func:`write_steps` writes in place, as XLA writes a
``dynamic_update_slice`` into its dead operand's buffer under ``jit``.
The per-particle form writes out of place (a mapped value cannot be
written into an unmapped tensor). ``STORE_WRITES`` counts the batched
writes of each kind.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import torch

from .tree import tree_flatten, tree_unflatten, flatten_up_to

__all__ = ["StepStorage", "StorageLayout", "LeafSpec", "make_storage",
           "unpack_tree", "read_step", "write_steps", "zeros_column",
           "pack_column", "fits_layout", "put_rows", "StaticColumn",
           "holds_store", "put_extra", "owned", "storage_of", "is_whole",
           "may_overwrite", "static_inputs", "zeros_storage",
           "STORE_WRITES"]

_KIND_MAT = 0
_KIND_EXTRA = 1
_KIND_ZERO = 2

_PACKABLE = (torch.float32, torch.int32, torch.bool)

#: the batched writes of :func:`write_steps`: ``copied``, into a copy of
#: the whole ``mat``; ``in_place``, into an owned ``mat`` itself
STORE_WRITES = {"copied": 0, "in_place": 0}

# one (storage addresses, holder) per owned() scope
_OWNED: list = []
# one set of storage addresses per static_inputs() scope
_STATIC: list = []


def storage_of(x) -> int:
    """The address of ``x``'s storage: tensors that share one share it."""
    return x.untyped_storage().data_ptr()


def is_whole(x) -> bool:
    """Whether ``x`` is its whole storage, contiguous from offset 0."""
    return (x.is_contiguous() and x.storage_offset() == 0
            and x.untyped_storage().nbytes() == x.numel() * x.itemsize)


def _alone(x) -> bool:
    """Whether ``x`` is the only tensor on its storage, anywhere: every
    tensor on a storage holds one count of it, as does the handle read
    here (the count PyTorch's CUDA-graph trees read to tell a live
    storage). A view, a tensor that shares the storage, or one that waits
    for the garbage collector makes it False."""
    return torch._C._storage_Use_Count(x.untyped_storage()._cdata) == 2


@contextlib.contextmanager
def _pushed(stack: list, item):
    stack.append(item)
    try:
        yield
    finally:
        stack.pop()


def static_inputs(storages):
    """Inside: the storages at ``storages`` (addresses, as
    :func:`storage_of` gives them) are a capture's static inputs, which
    every replay reads: :func:`may_overwrite` refuses them."""
    return _pushed(_STATIC, frozenset(storages))


def may_overwrite(x, holder=None) -> bool:
    """The one rule for writing in place: whether a writer may overwrite
    the non-empty tensor ``x``, ``holder`` being the tree that donates it
    and is dead after the call (``None``: ``x`` is the writer's own). It
    may where ``x`` is its whole contiguous storage, no static input is
    on that storage, and no other tensor of ``holder`` is (where none at
    all is, by its use count, without a walk). It counts tensors, not the
    places a tree holds one."""
    if not is_whole(x):
        return False
    at = storage_of(x)
    if any(at in s for s in _STATIC):
        return False
    return holder is None or _alone(x) or all(
        y is x for y in tree_flatten(holder)[0]
        if isinstance(y, torch.Tensor) and y.numel() and storage_of(y) == at)


def owned(storages, holder=None):
    """Inside: the writers own the storages ``storages`` (addresses),
    which nothing reads after the call, so :func:`write_steps` writes a
    store whose ``mat`` is one of them in place where
    :func:`may_overwrite` allows it, ``holder`` their donating tree (a
    state; ``None``: the writer built them). Scopes nest."""
    return _pushed(_OWNED, (frozenset(storages), holder))


def _owns(mat) -> bool:
    if not _OWNED or mat.numel() == 0:
        return False
    at = storage_of(mat)
    return any(at in mine and may_overwrite(mat, holder)
               for mine, holder in _OWNED)


class LeafSpec(NamedTuple):
    """Static descriptor of one leaf of the logical stacked tree."""
    kind: int           # _KIND_MAT | _KIND_EXTRA | _KIND_ZERO
    off: int            # mat: row offset within a step slab; extra: index
    width: int          # mat: rows per step (= prod(tail))
    dtype: torch.dtype  # dtype of the logical leaf
    tail: Tuple[int, ...]  # per-step value shape EXCLUDING the particle axis
    pax: object         # particle-axis position in the stacked leaf, or None


class StorageLayout(NamedTuple):
    """Static layout: logical treedef + per-leaf specs."""
    treedef: object
    specs: Tuple[LeafSpec, ...]
    T: int
    R: int


class StaticColumn:
    """Per-step Python values of one stacked leaf (a tree leaf, not a
    node): the active lengths of an Unfold inside an Unfold step, one per
    outer step. Immutable; :meth:`with_value` returns a copy with one step
    replaced. Indexing by step gives the Python value."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = tuple(values)

    def __getitem__(self, t):
        return self.values[t]

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __eq__(self, other):
        return (isinstance(other, StaticColumn)
                and self.values == other.values)

    def __hash__(self):
        return hash(self.values)

    def __repr__(self):
        return f"StaticColumn{self.values}"

    def with_value(self, t: int, v) -> "StaticColumn":
        if isinstance(v, torch.Tensor):
            raise TypeError(
                "a Python number stored per step (the active length of an "
                "Unfold called inside an Unfold step) was computed from a "
                "tensor; compute it from Python values (the step index and "
                "model constants), so that no device value is read")
        vals = list(self.values)
        vals[t] = v
        return StaticColumn(vals)


def holds_store(treedef) -> bool:
    """Whether a treedef holds a :class:`StepStorage` node: a column that
    holds another combinator's packed store (an Unfold inside an Unfold
    step), whose stacked form its own readers cannot take."""
    if treedef.kind is StepStorage:
        return True
    return any(holds_store(c) for c in treedef.children)


class StepStorage:
    """``mat`` (int32 ``[T*R, N]``, or ``None`` when no leaf packs) plus
    ``extras`` (tuple of ordinary stacked leaves) and the static layout."""

    __slots__ = ("mat", "extras", "layout")

    def __init__(self, mat, extras, layout: StorageLayout):
        self.mat = mat
        self.extras = tuple(extras)
        self.layout = layout

    def tree_flatten(self):
        return (self.mat, self.extras), self.layout

    @classmethod
    def tree_unflatten(cls, layout, children):
        return cls(children[0], children[1], layout)

    def __repr__(self):
        m = None if self.mat is None else tuple(self.mat.shape)
        return (f"StepStorage(mat={m}, extras={len(self.extras)}, "
                f"T={self.layout.T}, R={self.layout.R})")

    @property
    def batched(self):
        """True when ``mat`` carries the particle (minor) axis. A storage
        with no packed leaf is form-degenerate: both answers hold."""
        return self.mat is not None and self.mat.dim() == 2

    @property
    def n(self):
        return self.mat.shape[-1] if self.batched else None


def _bitcast(x, dtype):
    """``x.view(dtype)`` for a same-size dtype, also for a tensor a
    ``vmap_gfi`` map has mapped: PyTorch before 2.12 has no batching rule
    for a dtype view, so a mapped tensor is viewed under its mapping and
    wrapped again at the same level and axis."""
    F = torch._C._functorch
    if not F.is_batchedtensor(x):
        return x.view(dtype)
    return F._add_batch_dim(_bitcast(F.get_unwrapped(x), dtype),
                            F.maybe_get_bdim(x), F.maybe_get_level(x))


def _to_i32(x, dtype):
    if dtype == torch.float32:
        return _bitcast(x.contiguous(), torch.int32)
    if dtype == torch.int32:
        return x
    return x.to(torch.int32)


def _from_i32(x, dtype):
    if dtype == torch.float32:
        return _bitcast(x.contiguous(), torch.float32)
    if dtype == torch.bool:
        return x != 0
    return x.to(dtype)


def _prod(t):
    p = 1
    for v in t:
        p *= int(v)
    return p


def _leaf_specs(leaves, spec_elems, T: int, batched: bool):
    """The :class:`LeafSpec` of each leaf of a logical stacked tree (read
    for its shape and dtype only) and the packed rows per step ``R``."""
    specs, off, n_extras = [], 0, 0
    for leaf, ax in zip(leaves, spec_elems):
        if isinstance(leaf, StaticColumn):
            specs.append(LeafSpec(_KIND_EXTRA, n_extras, 0, None, (), None))
            n_extras += 1
            continue
        shape = tuple(leaf.shape)
        pax = ax if isinstance(ax, int) else None
        packable = (leaf.dtype in _PACKABLE and len(shape) >= 1
                    and shape[0] == T and pax is not None
                    and (not batched or len(shape) > pax))
        if not packable:
            specs.append(LeafSpec(_KIND_EXTRA, n_extras, 0, leaf.dtype,
                                  (), pax))
            n_extras += 1
            continue
        tail = (shape[1:pax] + shape[pax + 1:]) if batched else shape[1:]
        if _prod(shape) == 0:
            specs.append(LeafSpec(_KIND_ZERO, -1, 0, leaf.dtype, tail, pax))
            continue
        w = _prod(tail)
        specs.append(LeafSpec(_KIND_MAT, off, w, leaf.dtype, tail, pax))
        off += w
    return specs, off


def make_storage(tree, spec, T: int, batched: bool = True) -> StepStorage:
    """Build packed storage from the logical stacked tree (leaves
    ``[T, ...]``) and its particle-axis spec tree (int or ``None`` per
    leaf, particle axis counted with the time axis in front). A leaf packs
    iff it has a packable dtype, leading ``T``, a particle axis, and
    non-zero size; ``[T, ...pre, N, ...post]`` moves its particle axis last
    and becomes ``[T, w, N]`` rows. ``batched=False`` builds the
    per-particle form (inside a ``vmap_gfi`` map, where the spec position
    records where the map inserts the particle axis): ``[T, ...]`` leaves
    become ``[T, w]`` rows. The batched ``mat`` is a tensor of its own,
    not a view, so that a writer may own it (:func:`owned`)."""
    leaves, treedef = tree_flatten(tree)
    specs, R = _leaf_specs(leaves, flatten_up_to(treedef, spec), T,
                           batched)
    parts, extras = [], []
    for leaf, s in zip(leaves, specs):
        if s.kind == _KIND_EXTRA:
            extras.append(leaf)
        elif s.kind == _KIND_MAT:
            x = _to_i32(leaf, s.dtype)
            if not batched:
                parts.append(x.reshape(T, s.width))
                continue
            if s.pax != leaf.dim() - 1:
                x = torch.movedim(x, s.pax, -1)
            parts.append(x.reshape(T, s.width, leaf.shape[s.pax]))
    mat = None
    if parts and batched:
        mat = torch.empty((T * R, parts[0].shape[-1]), dtype=torch.int32,
                          device=parts[0].device)
        torch.cat(parts, dim=1, out=mat.view(T, R, -1))
    elif parts:
        mat = torch.cat(parts, dim=1).reshape(T * R)
    return StepStorage(mat, tuple(extras),
                       StorageLayout(treedef, tuple(specs), T, R))


def zeros_storage(col, spec, T: int, batched: bool = True) -> StepStorage:
    """The packed storage of ``T`` steps of structural zeros, whose
    per-step column tree is ``col`` (tensors, and Python numbers stored as
    a :class:`StaticColumn`) and whose spec is ``spec`` (of the stacked
    tree, as :func:`make_storage` takes it): one zero-filled ``mat``
    (all-zero words are the float32, int32 and bool zeros, so it holds the
    bits :func:`make_storage` packs from zeros) and zero extras, each
    allocated once."""
    leaves, treedef = tree_flatten(col)
    stacked = [StaticColumn([type(l)(0)] * T)
               if isinstance(l, (bool, int, float))
               else torch.empty((T,) + tuple(l.shape), dtype=l.dtype,
                                device="meta")
               for l in leaves]
    specs, R = _leaf_specs(stacked, flatten_up_to(treedef, spec), T,
                           batched)
    extras, n, device = [], None, None
    for leaf, x, s in zip(leaves, stacked, specs):
        if isinstance(x, StaticColumn):
            extras.append(x)
            continue
        if s.kind == _KIND_EXTRA:
            extras.append(torch.zeros(tuple(x.shape), dtype=x.dtype,
                                      device=leaf.device))
        elif s.kind == _KIND_MAT:
            n, device = x.shape[s.pax] if batched else None, leaf.device
    mat = None
    if R:
        mat = torch.zeros((T * R,) if n is None else (T * R, n),
                          dtype=torch.int32, device=device)
    return StepStorage(mat, tuple(extras),
                       StorageLayout(treedef, tuple(specs), T, R))


def _column_from_rows(rows, s: LeafSpec):
    """[w, N] (per particle: [w]) slab rows -> the logical per-step column
    value."""
    if rows.dim() == 1:
        return _from_i32(rows.reshape(s.tail), s.dtype)
    n = rows.shape[-1]
    x = rows.reshape(s.tail + (n,))
    cax = s.pax - 1   # column pax: stacked pax minus the time axis
    if cax != x.dim() - 1:
        x = torch.movedim(x, -1, cax)
    return _from_i32(x, s.dtype)


def _rows_from_column(v, s: LeafSpec, device):
    """Logical per-step column value -> the per-particle form's ``[w]``
    slab rows. Under-shaped values (shared or scalar values written into a
    per-particle leaf) broadcast in."""
    x = torch.as_tensor(v, device=device).to(s.dtype)
    if tuple(x.shape) != s.tail:
        x = x.expand(s.tail)
    return _to_i32(x, s.dtype).reshape(s.width)


def _unpack_leaf(st: StepStorage, s: LeafSpec, m3):
    T, n = st.layout.T, st.n
    if s.kind == _KIND_EXTRA:
        return st.extras[s.off]
    if n is None:
        if s.kind == _KIND_ZERO:
            return torch.zeros((T,) + s.tail, dtype=s.dtype,
                               device=None if st.mat is None
                               else st.mat.device)
        return _from_i32(m3[:, s.off:s.off + s.width].reshape(
            (T,) + s.tail), s.dtype)
    if s.kind == _KIND_ZERO:
        x = torch.zeros((T,) + s.tail + (n,), dtype=s.dtype,
                        device=None if st.mat is None else st.mat.device)
        return x if s.pax == x.dim() - 1 else torch.movedim(x, -1, s.pax)
    x = m3[:, s.off:s.off + s.width].reshape((T,) + s.tail + (n,))
    if s.pax != x.dim() - 1:
        x = torch.movedim(x, -1, s.pax)
    return _from_i32(x, s.dtype)


def unpack_tree(st: StepStorage, part=None):
    """Materialize the full logical stacked tree (cold paths: choicemaps,
    statistics), or with ``part`` only the subtree under that key of its
    top-level dict (an Unfold's ``"retval"`` carries)."""
    lo = st.layout
    m3 = None if st.mat is None else st.mat.reshape(
        (lo.T, lo.R) + tuple(st.mat.shape[1:]))
    if part is None:
        return tree_unflatten(lo.treedef,
                              [_unpack_leaf(st, s, m3) for s in lo.specs])
    td = lo.treedef
    i = td.aux.index(part)
    lo_i = sum(c.n_leaves for c in td.children[:i])
    child = td.children[i]
    return tree_unflatten(child, [
        _unpack_leaf(st, s, m3)
        for s in lo.specs[lo_i:lo_i + child.n_leaves]])


def read_step(st: StepStorage, t: int):
    """The logical per-step column tree at step ``t``: one row-slab slice
    of ``mat`` plus per-extra leading-axis reads."""
    lo = st.layout
    slab = None if st.mat is None else st.mat[t * lo.R:(t + 1) * lo.R]
    n = st.n
    out = []
    for s in lo.specs:
        if s.kind == _KIND_MAT:
            out.append(_column_from_rows(slab[s.off:s.off + s.width], s))
        elif s.kind == _KIND_ZERO:
            out.append(_zero_column_leaf(s, n, slab.device))
        else:
            out.append(st.extras[s.off][t])
    return tree_unflatten(lo.treedef, out)


def _zero_column_leaf(s: LeafSpec, n, device):
    if n is None:
        return torch.zeros(s.tail, dtype=s.dtype, device=device)
    x = torch.zeros(s.tail + (n,), dtype=s.dtype, device=device)
    cax = s.pax - 1
    if cax != x.dim() - 1:
        x = torch.movedim(x, -1, cax)
    return x


def zeros_column(st: StepStorage):
    """A structural-zeros per-step column tree (the extension proto)."""
    lo = st.layout
    n = st.n
    device = st.mat.device if st.mat is not None else None
    out = []
    for s in lo.specs:
        if s.kind == _KIND_EXTRA:
            e = st.extras[s.off]
            out.append(type(e[0])(0) if isinstance(e, StaticColumn)
                       else torch.zeros(tuple(e.shape[1:]), dtype=e.dtype,
                                        device=e.device))
        else:
            out.append(_zero_column_leaf(s, n, device))
    return tree_unflatten(lo.treedef, out)


def _put_column(dst, v, s: LeafSpec, n):
    """Write the logical per-step column value ``v`` into its ``[w, N]``
    rows ``dst`` of the batched form, in one copy: under-shaped values
    (shared or scalar values written into a per-particle leaf) broadcast
    in."""
    x = torch.as_tensor(v, device=dst.device).to(s.dtype)
    cax = s.pax - 1
    full = s.tail[:cax] + (n,) + s.tail[cax:]
    d = dst.view(s.tail + (n,))
    if cax != len(full) - 1:
        d = torch.movedim(d, -1, cax)
    if s.dtype == torch.float32:
        d = d.view(torch.float32)
    d.copy_(x if tuple(x.shape) == full else x.expand(full))


def _pack(st: StepStorage, vals, out=None):
    """:func:`pack_column` of a column flattened to ``st``'s specs. The
    batched form writes each packed leaf into its rows of ``out`` (int32
    ``[R, N]``), which is the slab; the per-particle form concatenates the
    leaves' ``[w]`` rows."""
    parts = []
    extra_cols = [None] * len(st.extras)
    for v, s in zip(vals, st.layout.specs):
        if s.kind == _KIND_MAT:
            if out is None:
                parts.append(_rows_from_column(v, s, st.mat.device))
            else:
                _put_column(out[s.off:s.off + s.width], v, s, st.n)
        elif s.kind == _KIND_EXTRA:
            extra_cols[s.off] = v
    if out is not None or not parts:
        return out, extra_cols
    return torch.cat(parts, dim=0), extra_cols


def pack_column(st: StepStorage, col_tree):
    """Logical per-step column tree -> ``(slab [R, N], extra_cols)``."""
    out = None
    if st.batched:
        out = torch.empty((st.layout.R, st.n), dtype=torch.int32,
                          device=st.mat.device)
    return _pack(st, flatten_up_to(st.layout.treedef, col_tree), out)


def fits_layout(st: StepStorage, cols) -> bool:
    """Whether per-step column trees can be written into ``st``'s layout:
    False when a value with a particle axis would land in a leaf the
    layout stores shared across particles (the writer then rebuilds the
    layout, as the JAX package's full scans derive it from their
    outputs)."""
    lo = st.layout
    mapped = torch._C._functorch.is_batchedtensor
    for col in cols:
        for v, s in zip(flatten_up_to(lo.treedef, col), lo.specs):
            if s.kind != _KIND_EXTRA or s.pax is not None:
                continue
            e = st.extras[s.off]
            if isinstance(e, StaticColumn):
                e.with_value(0, v)    # raises for a tensor value
                continue
            v = torch.as_tensor(v)
            # per particle, a value that differs across particles is a
            # mapped tensor of the per-particle shape
            if v.dim() > e.dim() - 1 or (mapped(v) and not mapped(e)):
                return False
    return True


def put_rows(x, start: int, rows):
    """``x`` with ``rows`` in place of ``x[start:start + len(rows)]``, out
    of place: the per-particle form's write, where ``rows`` may be mapped
    and ``x`` not."""
    end = start + rows.shape[0]
    return torch.cat([x[:start], rows.to(x.dtype), x[end:]])


def put_extra(e, t: int, v, per_particle: bool, copied: bool):
    """Extra ``e`` with step ``t`` set to ``v``: a new :class:`StaticColumn`
    for a static extra, an out-of-place row write per particle, else an
    in-place write into ``e`` (into a copy first unless ``copied``)."""
    if isinstance(e, StaticColumn):
        return e.with_value(t, v)
    v = torch.as_tensor(v, dtype=e.dtype, device=e.device)
    if per_particle:
        return put_rows(e, t, v[None])
    if not copied:
        e = e.clone()
    e[t] = v
    return e


def _apart(flat, specs, mat):
    """Flattened columns with each packed value that shares ``mat``'s
    storage cloned, so that a write into ``mat`` in place reads nothing it
    has written (a re-scan's column keeps views of the old rows)."""
    at = storage_of(mat)

    def shares(v, s):
        return (s.kind == _KIND_MAT and isinstance(v, torch.Tensor)
                and v.numel() > 0 and storage_of(v) == at)
    return [[v.clone() if shares(v, s) else v for v, s in zip(vals, specs)]
            for vals in flat]


def write_steps(st: StepStorage, t0: int, cols) -> StepStorage:
    """Write ``k = len(cols)`` consecutive per-step column trees starting
    at step ``t0``: each packed leaf's rows written into ``mat`` in place
    where the writer owns it (:func:`owned`), else into a copy of the
    whole ``mat`` (counted in ``STORE_WRITES``), plus per-extra row writes
    on copies of the extras (per particle: all out of place,
    :func:`put_rows`)."""
    lo = st.layout
    mat = st.mat
    batched = mat is not None and st.batched
    per_particle = mat is not None and not st.batched
    flat = [flatten_up_to(lo.treedef, c) for c in cols]
    if batched and flat:
        if _owns(mat):
            STORE_WRITES["in_place"] += 1
            if not _alone(mat):
                flat = _apart(flat, lo.specs, mat)
        else:
            STORE_WRITES["copied"] += 1
            mat = mat.clone(memory_format=torch.contiguous_format)
    extras = list(st.extras)
    copied = set()
    slabs = []
    for j, vals in enumerate(flat):
        t = t0 + j
        if batched:
            _, extra_cols = _pack(st, vals, out=mat[t * lo.R:(t + 1) * lo.R])
        else:
            slab, extra_cols = _pack(st, vals)
            if slab is not None:
                slabs.append(slab)
        for i, v in enumerate(extra_cols):
            if v is None:
                continue
            extras[i] = put_extra(extras[i], t, v, per_particle,
                                  i in copied)
            copied.add(i)
    if slabs:
        mat = put_rows(mat, t0 * lo.R, torch.cat(slabs, dim=0))
    return StepStorage(mat, tuple(extras), lo)
