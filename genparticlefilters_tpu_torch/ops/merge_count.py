"""G4: the merge count of two sorted float sequences.

``merge_count(c, u)`` takes ascending non-negative float32 ``c [n]`` and
ascending float32 ``u [m]`` (values below 2.0) and returns int32
``F [n]``, ``F_i = #{j : u_j <= c_i}`` (ties count). It is the core of the
sort-free multinomial and residual hit counts (smc/resample.py). A float32
cumsum computed on the card can dip by an ulp; the kernel then counts for
the running maximum of ``c``, which is what the callers' cummax of ``F``
(``_pinned_F``) makes of the plain per-element count.

On a CUDA tensor it launches the hand-written kernel of
``csrc/merge_count.cu`` (built at first use, see ops/build.py); on a CPU
tensor it runs :func:`merge_count_plain`, the same function in plain
PyTorch. There is no other route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import launch_on, load_library

__all__ = ["merge_count", "merge_count_plain"]

_LIB = "merge_count"


def _bind(lib):
    fn = lib.merge_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int


@functools.cache
def _library():
    return load_library(_LIB, _bind)


def _check(c: torch.Tensor, u: torch.Tensor):
    for name, x in (("c", c), ("u", u)):
        if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 \
                or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 1-D "
                             f"tensor")
    if u.device != c.device:
        raise ValueError(f"u on {u.device}, c on {c.device}")


def merge_count_plain(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`merge_count`."""
    _check(c, u)
    return torch.searchsorted(u, c, right=True, out_int32=True)


def merge_count(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``F_i = #{j : u_j <= c_i}`` as int32 ``[n]`` (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch the
    kernel, and a failed build or launch raises."""
    _check(c, u)
    if c.device.type == "cpu":
        return merge_count_plain(c, u)
    if c.device.type != "cuda":
        raise ValueError(f"merge_count runs on cpu or cuda tensors, not "
                         f"{c.device}")
    lib = _library()
    n, m = c.shape[0], u.shape[0]
    F = torch.empty((n,), dtype=torch.int32, device=c.device)
    if n == 0:
        return F
    err = launch_on(c.device, lib.merge_count, c.data_ptr(), n, u.data_ptr(),
                    m, F.data_ptr())
    if err != 0:
        raise RuntimeError(f"merge_count launch failed: CUDA error {err}")
    merge_count.launches += 1
    return F


#: kernel launches made by :func:`merge_count` (CUDA tensors only)
merge_count.launches = 0
