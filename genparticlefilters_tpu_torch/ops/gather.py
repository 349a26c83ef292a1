"""G3: the explicit-parents ancestry gather.

``gather_cols(pieces, parents)`` takes int32 pieces ``[w_i, N]`` (particles
last, the packed trace layout) and int32 ``parents [M]`` and returns one
``[w_i, M]`` output per piece, ``out_i[:, j] = piece_i[:, parents[j]]``.
``gather_rows(pieces, parents)`` takes pieces ``[N, w_i]`` (particles first)
and returns ``[M, w_i]`` outputs, ``out_i[j] = piece_i[parents[j]]``.
Parents may come in any order (clustered from resampling, or an arbitrary
permutation) and M may differ from N; they must lie in ``[0, N)``, which
is not checked on the device.

On a CUDA tensor each wrapper launches the hand-written kernel of
``csrc/gather_parents.cu`` once for all pieces (built at first use, see
ops/build.py); on a CPU tensor it runs its ``*_plain`` version, an
``index_select`` per piece. There is no other route. Row mode copies a
piece in 16-byte units where :func:`_vector_width` allows it, else in
4-byte units.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from .build import launch_on, load_library
from .fused_gather import _launch_tables

__all__ = ["gather_cols", "gather_cols_plain", "gather_rows",
           "gather_rows_plain"]

_LIB = "gather_parents"


def _bind(lib):
    tail = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
    lib.gather_cols.argtypes = [ctypes.c_void_p] * 3 + tail
    lib.gather_rows.argtypes = [ctypes.c_void_p] * 4 + tail
    for fn in (lib.gather_cols, lib.gather_rows):
        fn.restype = ctypes.c_int
    lib.gather_parents_max_pieces.argtypes = []
    lib.gather_parents_max_pieces.restype = ctypes.c_int


@functools.cache
def _library():
    """(the loaded library, its most pieces per launch)"""
    lib = load_library(_LIB, _bind)
    return lib, lib.gather_parents_max_pieces()


def _vector_width(width: int, src_ptr: int, dst_ptr: int) -> int:
    """Row mode's unit for one piece, in int32 values: 4 (16-byte loads and
    stores) when a row of ``width`` values is whole 16-byte units and both
    the piece's and its output's addresses are 16-byte aligned; else 1 (a
    view with a storage offset, a width not a multiple of 4)."""
    return 4 if width % 4 == 0 and src_ptr % 16 == 0 \
        and dst_ptr % 16 == 0 else 1


def _check(pieces: Sequence[torch.Tensor], parents: torch.Tensor,
           axis: int):
    """N, the particle count of the pieces (``None`` without pieces)."""
    if not isinstance(parents, torch.Tensor) \
            or parents.dtype != torch.int32 or parents.dim() != 1 \
            or not parents.is_contiguous():
        raise ValueError("parents must be a contiguous int32 [M] tensor")
    n = None
    for p in pieces:
        if p.dtype != torch.int32 or p.dim() != 2 or not p.is_contiguous():
            raise ValueError(f"every piece must be a contiguous int32 2-D "
                             f"tensor, got {p.dtype} {tuple(p.shape)}")
        if p.device != parents.device:
            raise ValueError(f"piece on {p.device}, parents on "
                             f"{parents.device}")
        n = p.shape[axis] if n is None else n
        if p.shape[axis] != n or n == 0:
            raise ValueError(f"pieces disagree on the particle count: "
                             f"{tuple(p.shape)} against N={n}")
    return n


def gather_cols_plain(pieces: Sequence[torch.Tensor],
                      parents: torch.Tensor) -> List[torch.Tensor]:
    """The plain PyTorch version of :func:`gather_cols`."""
    _check(pieces, parents, 1)
    idx = parents.long()
    return [torch.index_select(p, 1, idx) for p in pieces]


def gather_rows_plain(pieces: Sequence[torch.Tensor],
                      parents: torch.Tensor) -> List[torch.Tensor]:
    """The plain PyTorch version of :func:`gather_rows`."""
    _check(pieces, parents, 0)
    idx = parents.long()
    return [torch.index_select(p, 0, idx) for p in pieces]


def _launch(name, pieces, parents, axis, out_shape):
    """Check, allocate and launch ``name`` of the library once; returns the
    outputs (no launch when there is nothing to move)."""
    n = _check(pieces, parents, axis)
    dev = parents.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")
    lib, max_pieces = _library()
    if len(pieces) > max_pieces:
        raise ValueError(f"{len(pieces)} pieces exceed the kernel's "
                         f"{max_pieces}")
    m = parents.shape[0]
    outs = [torch.empty(out_shape(p, m), dtype=torch.int32, device=dev)
            for p in pieces]
    widths = [p.shape[1 - axis] for p in pieces]
    if m == 0 or not any(widths):
        return outs, False
    tables = list(_launch_tables(pieces, outs, widths))
    if axis == 0:
        vec = (ctypes.c_int32 * len(pieces))(*[
            _vector_width(w, p.data_ptr(), o.data_ptr())
            for w, p, o in zip(widths, pieces, outs)])
        tables.append(ctypes.cast(vec, ctypes.c_void_p))
    err = launch_on(dev, getattr(lib, name), *tables, len(pieces),
                    parents.data_ptr(), n, m)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return outs, True


def gather_cols(pieces: Sequence[torch.Tensor],
                parents: torch.Tensor) -> List[torch.Tensor]:
    """Explicit-parents gather of ``[w_i, N]`` pieces into ``[w_i, M]``
    outputs (see the module docstring). CPU tensors take the plain version;
    CUDA tensors launch the kernel once, and a failed build or launch
    raises."""
    pieces = list(pieces)
    if parents.device.type == "cpu":
        return gather_cols_plain(pieces, parents)
    outs, launched = _launch("gather_cols", pieces, parents, 1,
                             lambda p, m: (p.shape[0], m))
    gather_cols.launches += launched
    return outs


def gather_rows(pieces: Sequence[torch.Tensor],
                parents: torch.Tensor) -> List[torch.Tensor]:
    """Explicit-parents gather of ``[N, w_i]`` pieces into ``[M, w_i]``
    outputs (see the module docstring). CPU tensors take the plain version;
    CUDA tensors launch the kernel once, and a failed build or launch
    raises."""
    pieces = list(pieces)
    if parents.device.type == "cpu":
        return gather_rows_plain(pieces, parents)
    outs, launched = _launch("gather_rows", pieces, parents, 0,
                             lambda p, m: (m, p.shape[1]))
    gather_rows.launches += launched
    return outs


#: kernel launches made by :func:`gather_cols` (CUDA tensors only)
gather_cols.launches = 0
#: kernel launches made by :func:`gather_rows` (CUDA tensors only)
gather_rows.launches = 0
