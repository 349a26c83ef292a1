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
its input untouched; the per-particle form writes out of place (a mapped
value cannot be written into an unmapped tensor).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .tree import tree_flatten, tree_unflatten, flatten_up_to

__all__ = ["StepStorage", "StorageLayout", "LeafSpec", "make_storage",
           "unpack_tree", "read_step", "write_steps", "zeros_column",
           "pack_column", "fits_layout", "put_rows", "StaticColumn",
           "holds_store", "put_extra"]

_KIND_MAT = 0
_KIND_EXTRA = 1
_KIND_ZERO = 2

_PACKABLE = (torch.float32, torch.int32, torch.bool)


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


def make_storage(tree, spec, T: int, batched: bool = True) -> StepStorage:
    """Build packed storage from the logical stacked tree (leaves
    ``[T, ...]``) and its particle-axis spec tree (int or ``None`` per
    leaf, particle axis counted with the time axis in front). A leaf packs
    iff it has a packable dtype, leading ``T``, a particle axis, and
    non-zero size; ``[T, ...pre, N, ...post]`` moves its particle axis last
    and becomes ``[T, w, N]`` rows. ``batched=False`` builds the
    per-particle form (inside a ``vmap_gfi`` map, where the spec position
    records where the map inserts the particle axis): ``[T, ...]`` leaves
    become ``[T, w]`` rows."""
    leaves, treedef = tree_flatten(tree)
    spec_elems = flatten_up_to(treedef, spec)
    specs, parts, extras = [], [], []
    off = 0
    for leaf, ax in zip(leaves, spec_elems):
        if isinstance(leaf, StaticColumn):
            specs.append(LeafSpec(_KIND_EXTRA, len(extras), 0, None, (),
                                  None))
            extras.append(leaf)
            continue
        shape = tuple(leaf.shape)
        pax = ax if isinstance(ax, int) else None
        packable = (leaf.dtype in _PACKABLE and len(shape) >= 1
                    and shape[0] == T and pax is not None
                    and (not batched or len(shape) > pax))
        if not packable:
            specs.append(LeafSpec(_KIND_EXTRA, len(extras), 0, leaf.dtype,
                                  (), pax))
            extras.append(leaf)
            continue
        tail = (shape[1:pax] + shape[pax + 1:]) if batched else shape[1:]
        if _prod(shape) == 0:
            specs.append(LeafSpec(_KIND_ZERO, -1, 0, leaf.dtype, tail, pax))
            continue
        x = _to_i32(leaf, leaf.dtype)
        w = _prod(tail)
        if batched:
            if pax != len(shape) - 1:
                x = torch.movedim(x, pax, -1)
            x = x.reshape(T, w, shape[pax])
        else:
            x = x.reshape(T, w)
        specs.append(LeafSpec(_KIND_MAT, off, w, leaf.dtype, tail, pax))
        off += w
        parts.append(x)
    R = off
    mat = None
    if parts:
        cat = torch.cat(parts, dim=1)
        mat = (cat.reshape(T * R, -1).contiguous() if batched
               else cat.reshape(T * R))
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


def _rows_from_column(v, s: LeafSpec, n, device):
    """Logical per-step column value -> [w, N] slab rows (``n`` None: the
    per-particle form's [w]). Under-shaped values (shared or scalar values
    written into a per-particle leaf) broadcast in."""
    x = torch.as_tensor(v, device=device).to(s.dtype)
    if n is None:
        if tuple(x.shape) != s.tail:
            x = x.expand(s.tail)
        return _to_i32(x, s.dtype).reshape(s.width)
    cax = s.pax - 1
    full = s.tail[:cax] + (n,) + s.tail[cax:]
    if tuple(x.shape) != full:
        x = x.expand(full)
    x = _to_i32(x, s.dtype)
    if cax != len(full) - 1:
        x = torch.movedim(x, cax, -1)
    return x.reshape(s.width, n)


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


def pack_column(st: StepStorage, col_tree):
    """Logical per-step column tree -> ``(slab [R, N], extra_cols)``."""
    lo = st.layout
    n = st.n
    cols = flatten_up_to(lo.treedef, col_tree)
    parts = []
    extra_cols = [None] * len(st.extras)
    for v, s in zip(cols, lo.specs):
        if s.kind == _KIND_MAT:
            parts.append(_rows_from_column(v, s, n, st.mat.device))
        elif s.kind == _KIND_EXTRA:
            extra_cols[s.off] = v
    if not parts:
        return None, extra_cols
    return torch.cat(parts, dim=0), extra_cols


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


def write_steps(st: StepStorage, t0: int, cols) -> StepStorage:
    """Write ``k = len(cols)`` consecutive per-step column trees starting
    at step ``t0``: ONE ``[k*R, N]`` slab write on a copy of ``mat`` plus
    per-extra row writes on copies of the extras (per particle: out of
    place, :func:`put_rows`)."""
    lo = st.layout
    per_particle = st.mat is not None and not st.batched
    extras = list(st.extras)
    copied = set()
    slabs = []
    for j, col in enumerate(cols):
        slab, extra_cols = pack_column(st, col)
        if slab is not None:
            slabs.append(slab)
        for i, v in enumerate(extra_cols):
            if v is None:
                continue
            extras[i] = put_extra(extras[i], t0 + j, v, per_particle,
                                  i in copied)
            copied.add(i)
    mat = st.mat
    if slabs and mat is not None:
        if per_particle:
            mat = put_rows(mat, t0 * lo.R, torch.cat(slabs, dim=0))
        else:
            mat = mat.clone()
            mat[t0 * lo.R:(t0 + len(slabs)) * lo.R] = torch.cat(slabs,
                                                                dim=0)
    return StepStorage(mat, tuple(extras), lo)
