"""G1 and G2: the fused resampling gathers.

G1 gathers from cumulative hit counts, G2 from float brackets.

``resample_gather_split(pieces, F, n_out)`` takes the per-leaf row pieces
``[w_i, N]`` of a batched trace and nondecreasing hit counts ``F [N]``
(``F[-1] == n_out``) and returns one gathered ``[w_i, n_out]`` output per
piece plus the parents, ``parents[j] = #{i : F_i <= j}``:
``out_i[:, j] = piece_i[:, parents[j]]``.

``resample_gather_split_u(pieces, c, u)`` takes the same pieces, bracket
edges ``c [N]`` and ascending queries ``u [M]`` (float32) and gives output
slot j the parent ``p_j = #{s < N-1 : c[s] < max(u_j, 1e-37)}``: the
unique s with ``c[s-1] < u_j <= c[s]``, the last upper edge widened to a
catch-all. With zero pieces it returns only the parents (the residual
remainder count, roles swapped).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/stairs_gather.cu``, ``csrc/stairs_gather_u.cu``, built at first
use, see ops/build.py); on a CPU tensor it runs its ``*_plain`` version,
the same function in plain PyTorch. There is no other route.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .build import load_library

__all__ = ["resample_gather_split", "resample_gather_split_plain",
           "resample_gather_split_u", "resample_gather_split_u_plain"]

_LIB = "stairs_gather"
_LIB_U = "stairs_gather_u"


def _bind(lib):
    fn = lib.stairs_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.stairs_gather_max_pieces.argtypes = []
    lib.stairs_gather_max_pieces.restype = ctypes.c_int


def _bind_u(lib):
    fn = lib.stairs_gather_u
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.stairs_gather_u_max_pieces.argtypes = []
    lib.stairs_gather_u_max_pieces.restype = ctypes.c_int


def _check_pieces(pieces: Sequence[torch.Tensor], n: int, device):
    for p in pieces:
        if p.dtype != torch.int32 or p.dim() != 2 or p.shape[1] != n \
                or not p.is_contiguous():
            raise ValueError(f"every piece must be a contiguous int32 "
                             f"[w, {n}] tensor, got {p.dtype} "
                             f"{tuple(p.shape)}")
        if p.device != device:
            raise ValueError(f"piece on {p.device}, brackets on {device}")


def _check(pieces: Sequence[torch.Tensor], F: torch.Tensor, n_out):
    if not isinstance(F, torch.Tensor) or F.dtype != torch.int32 \
            or F.dim() != 1 or not F.is_contiguous():
        raise ValueError("F must be a contiguous int32 [N] tensor")
    n = F.shape[0]
    if n == 0:
        raise ValueError("F must hold at least one particle")
    m = n if n_out is None else int(n_out)
    if m < 0:
        raise ValueError(f"n_out must be >= 0, got {m}")
    _check_pieces(pieces, n, F.device)
    return n, m


def resample_gather_split_plain(pieces: Sequence[torch.Tensor],
                                F: torch.Tensor, n_out: int | None = None):
    """The plain PyTorch version of :func:`resample_gather_split`."""
    n, m = _check(pieces, F, n_out)
    j = torch.arange(m, dtype=torch.int32, device=F.device)
    parents = torch.searchsorted(F, j, right=True, out_int32=True)
    idx = parents.long()
    return [p[:, idx] for p in pieces], parents


def _launch_tables(pieces, outs, widths=None):
    """ctypes arrays of the pieces' and outputs' pointers and widths
    (``widths`` defaults to each piece's row count)."""
    k = max(len(pieces), 1)
    if widths is None:
        widths = [p.shape[0] for p in pieces]
    src = (ctypes.c_void_p * k)(*[p.data_ptr() for p in pieces])
    dst = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    rows = (ctypes.c_int32 * k)(*widths)
    return (ctypes.cast(src, ctypes.c_void_p),
            ctypes.cast(dst, ctypes.c_void_p),
            ctypes.cast(rows, ctypes.c_void_p))


def resample_gather_split(pieces: Sequence[torch.Tensor], F: torch.Tensor,
                          n_out: int | None = None):
    """Fused resampling gather (see the module docstring). Returns
    ``(outs, parents)``: ``outs[i]`` int32 ``[w_i, n_out]``, ``parents``
    int32 ``[n_out]``. CPU tensors take the plain version; CUDA tensors
    launch the kernel, and a failed build or launch raises."""
    pieces = list(pieces)
    n, m = _check(pieces, F, n_out)
    if F.device.type == "cpu":
        return resample_gather_split_plain(pieces, F, n_out)
    if F.device.type != "cuda":
        raise ValueError(f"resample_gather_split runs on cpu or cuda "
                         f"tensors, not {F.device}")
    lib = load_library(_LIB, _bind)
    if len(pieces) > lib.stairs_gather_max_pieces():
        raise ValueError(f"{len(pieces)} pieces exceed the kernel's "
                         f"{lib.stairs_gather_max_pieces()}")
    outs: List[torch.Tensor] = [
        torch.empty((p.shape[0], m), dtype=torch.int32, device=F.device)
        for p in pieces]
    parents = torch.empty((m,), dtype=torch.int32, device=F.device)
    if m == 0:
        return outs, parents
    src, dst, rows = _launch_tables(pieces, outs)
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.stairs_gather(src, dst, rows, len(pieces), F.data_ptr(),
                                n, m, parents.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stairs_gather launch failed: CUDA error {err}")
    resample_gather_split.launches += 1
    return outs, parents


#: kernel launches made by :func:`resample_gather_split` (CUDA tensors only)
resample_gather_split.launches = 0


def _check_u(pieces: Sequence[torch.Tensor], c: torch.Tensor,
             u: torch.Tensor):
    for name, x in (("c", c), ("u", u)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 1-D "
                             f"tensor")
    if u.device != c.device:
        raise ValueError(f"u on {u.device}, c on {c.device}")
    n = c.shape[0]
    if n == 0:
        raise ValueError("c must hold at least one bracket")
    _check_pieces(pieces, n, c.device)
    return n, u.shape[0]


def resample_gather_split_u_plain(pieces: Sequence[torch.Tensor],
                                  c: torch.Tensor, u: torch.Tensor):
    """The plain PyTorch version of :func:`resample_gather_split_u`."""
    _check_u(pieces, c, u)
    parents = torch.searchsorted(c[:-1], u.clamp_min(1e-37), right=False,
                                 out_int32=True)
    idx = parents.long()
    return [p[:, idx] for p in pieces], parents


def resample_gather_split_u(pieces: Sequence[torch.Tensor], c: torch.Tensor,
                            u: torch.Tensor):
    """Fused resampling gather from float brackets (see the module
    docstring). Returns ``(outs, parents)``: ``outs[i]`` int32
    ``[w_i, len(u)]``, ``parents`` int32 ``[len(u)]``. CPU tensors take the
    plain version; CUDA tensors launch the kernel, and a failed build or
    launch raises."""
    pieces = list(pieces)
    n, m = _check_u(pieces, c, u)
    if c.device.type == "cpu":
        return resample_gather_split_u_plain(pieces, c, u)
    if c.device.type != "cuda":
        raise ValueError(f"resample_gather_split_u runs on cpu or cuda "
                         f"tensors, not {c.device}")
    lib = load_library(_LIB_U, _bind_u)
    if len(pieces) > lib.stairs_gather_u_max_pieces():
        raise ValueError(f"{len(pieces)} pieces exceed the kernel's "
                         f"{lib.stairs_gather_u_max_pieces()}")
    outs: List[torch.Tensor] = [
        torch.empty((p.shape[0], m), dtype=torch.int32, device=c.device)
        for p in pieces]
    parents = torch.empty((m,), dtype=torch.int32, device=c.device)
    if m == 0:
        return outs, parents
    src, dst, rows = _launch_tables(pieces, outs)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.stairs_gather_u(src, dst, rows, len(pieces), c.data_ptr(),
                                  n, u.data_ptr(), m, parents.data_ptr(),
                                  stream)
    if err != 0:
        raise RuntimeError(f"stairs_gather_u launch failed: CUDA error "
                           f"{err}")
    resample_gather_split_u.launches += 1
    return outs, parents


#: kernel launches made by :func:`resample_gather_split_u` (CUDA only)
resample_gather_split_u.launches = 0
