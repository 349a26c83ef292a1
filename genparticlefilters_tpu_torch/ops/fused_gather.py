"""G1: the fused resampling gather from cumulative hit counts.

``resample_gather_split(pieces, F, n_out)`` takes the per-leaf row pieces
``[w_i, N]`` of a batched trace and nondecreasing hit counts ``F [N]``
(``F[-1] == n_out``) and returns one gathered ``[w_i, n_out]`` output per
piece plus the parents, ``parents[j] = #{i : F_i <= j}``:
``out_i[:, j] = piece_i[:, parents[j]]``.

On a CUDA tensor it launches the hand-written kernel of
``csrc/stairs_gather.cu`` (built at first use, see ops/build.py); on a CPU
tensor it runs :func:`resample_gather_split_plain`, the same function in
plain PyTorch. There is no other route.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from .build import load_library

__all__ = ["resample_gather_split", "resample_gather_split_plain"]

_LIB = "stairs_gather"


def _bind(lib):
    fn = lib.stairs_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.stairs_gather_max_pieces.argtypes = []
    lib.stairs_gather_max_pieces.restype = ctypes.c_int


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
    for p in pieces:
        if p.dtype != torch.int32 or p.dim() != 2 or p.shape[1] != n \
                or not p.is_contiguous():
            raise ValueError(f"every piece must be a contiguous int32 "
                             f"[w, {n}] tensor, got {p.dtype} "
                             f"{tuple(p.shape)}")
        if p.device != F.device:
            raise ValueError(f"piece on {p.device}, F on {F.device}")
    return n, m


def resample_gather_split_plain(pieces: Sequence[torch.Tensor],
                                F: torch.Tensor, n_out: int | None = None):
    """The plain PyTorch version of :func:`resample_gather_split`."""
    n, m = _check(pieces, F, n_out)
    j = torch.arange(m, dtype=torch.int32, device=F.device)
    parents = torch.searchsorted(F, j, right=True, out_int32=True)
    idx = parents.long()
    return [p[:, idx] for p in pieces], parents


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
    k = len(pieces)
    src = (ctypes.c_void_p * max(k, 1))(*[p.data_ptr() for p in pieces])
    dst = (ctypes.c_void_p * max(k, 1))(*[o.data_ptr() for o in outs])
    rows = (ctypes.c_int32 * max(k, 1))(*[p.shape[0] for p in pieces])
    with torch.cuda.device(F.device):
        stream = torch.cuda.current_stream(F.device).cuda_stream
        err = lib.stairs_gather(
            ctypes.cast(src, ctypes.c_void_p),
            ctypes.cast(dst, ctypes.c_void_p),
            ctypes.cast(rows, ctypes.c_void_p), k, F.data_ptr(), n, m,
            parents.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stairs_gather launch failed: CUDA error {err}")
    resample_gather_split.launches += 1
    return outs, parents


#: kernel launches made by :func:`resample_gather_split` (CUDA tensors only)
resample_gather_split.launches = 0
