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
are 0/1.

Only the batched form is ported. Writes are copy-on-write: every writer
returns a storage with new tensors and leaves its input untouched.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .tree import tree_flatten, tree_unflatten, flatten_up_to

__all__ = ["StepStorage", "StorageLayout", "LeafSpec", "make_storage",
           "unpack_tree", "read_step", "write_steps", "zeros_column",
           "pack_column", "fits_layout"]

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
    def n(self):
        return None if self.mat is None else self.mat.shape[-1]


def _to_i32(x, dtype):
    if dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    if dtype == torch.int32:
        return x
    return x.to(torch.int32)


def _from_i32(x, dtype):
    if dtype == torch.float32:
        return x.contiguous().view(torch.float32)
    if dtype == torch.bool:
        return x != 0
    return x.to(dtype)


def _prod(t):
    p = 1
    for v in t:
        p *= int(v)
    return p


def make_storage(tree, spec, T: int) -> StepStorage:
    """Build packed storage from the logical stacked tree (leaves
    ``[T, ...]``) and its particle-axis spec tree (int or ``None`` per
    leaf, particle axis counted with the time axis in front). A leaf packs
    iff it has a packable dtype, leading ``T``, a particle axis, and
    non-zero size; ``[T, ...pre, N, ...post]`` moves its particle axis last
    and becomes ``[T, w, N]`` rows."""
    leaves, treedef = tree_flatten(tree)
    spec_elems = flatten_up_to(treedef, spec)
    specs, parts, extras = [], [], []
    off = 0
    for leaf, ax in zip(leaves, spec_elems):
        shape = tuple(leaf.shape)
        pax = ax if isinstance(ax, int) else None
        packable = (leaf.dtype in _PACKABLE and len(shape) >= 1
                    and shape[0] == T and pax is not None
                    and len(shape) > pax)
        if not packable:
            specs.append(LeafSpec(_KIND_EXTRA, len(extras), 0, leaf.dtype,
                                  (), pax))
            extras.append(leaf)
            continue
        tail = shape[1:pax] + shape[pax + 1:]
        if _prod(shape) == 0:
            specs.append(LeafSpec(_KIND_ZERO, -1, 0, leaf.dtype, tail, pax))
            continue
        x = _to_i32(leaf, leaf.dtype)
        if pax != len(shape) - 1:
            x = torch.movedim(x, pax, -1)
        n = shape[pax]
        w = _prod(tail)
        specs.append(LeafSpec(_KIND_MAT, off, w, leaf.dtype, tail, pax))
        off += w
        parts.append(x.reshape(T, w, n))
    R = off
    mat = (torch.cat(parts, dim=1).reshape(T * R, -1).contiguous()
           if parts else None)
    return StepStorage(mat, tuple(extras),
                       StorageLayout(treedef, tuple(specs), T, R))


def _column_from_rows(rows, s: LeafSpec):
    """[w, N] slab rows -> the logical per-step column value."""
    n = rows.shape[-1]
    x = rows.reshape(s.tail + (n,))
    cax = s.pax - 1   # column pax: stacked pax minus the time axis
    if cax != x.dim() - 1:
        x = torch.movedim(x, -1, cax)
    return _from_i32(x, s.dtype)


def _rows_from_column(v, s: LeafSpec, n, device):
    """Logical per-step column value -> [w, N] slab rows. Under-shaped
    values (shared or scalar values written into a per-particle leaf)
    broadcast in."""
    x = torch.as_tensor(v, device=device).to(s.dtype)
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
    m3 = None if st.mat is None else st.mat.reshape(lo.T, lo.R, -1)
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
            out.append(torch.zeros(tuple(e.shape[1:]), dtype=e.dtype,
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
    for col in cols:
        for v, s in zip(flatten_up_to(lo.treedef, col), lo.specs):
            if s.kind == _KIND_EXTRA and s.pax is None and (
                    torch.as_tensor(v).dim() > st.extras[s.off].dim() - 1):
                return False
    return True


def write_steps(st: StepStorage, t0: int, cols) -> StepStorage:
    """Write ``k = len(cols)`` consecutive per-step column trees starting
    at step ``t0``: ONE ``[k*R, N]`` slab write on a copy of ``mat`` plus
    per-extra row writes on copies of the extras."""
    lo = st.layout
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
            if i not in copied:
                extras[i] = extras[i].clone()
                copied.add(i)
            extras[i][t0 + j] = torch.as_tensor(v, dtype=extras[i].dtype,
                                                device=extras[i].device)
    mat = st.mat
    if slabs and mat is not None:
        mat = mat.clone()
        mat[t0 * lo.R:(t0 + len(slabs)) * lo.R] = torch.cat(slabs, dim=0)
    return StepStorage(mat, tuple(extras), lo)
