"""G5: the running maximum along the last axis.

``max_scan(x)`` takes a contiguous int32 or float32 tensor with at least
one axis and returns ``torch.cummax(x, -1).values`` bit for bit: a NaN
sticks once seen, and on a tie (+0.0 against -0.0 included) the later
element wins. It is the monotone lift that keeps the resample verb's
cumulative hit counts and brackets non-decreasing where a parallel float
scan dips by an ulp (smc/resample.py ``_pinned_F``, ``_brackets``), and
the forward fill of ``counts_to_parents``.

On a CUDA tensor it launches the hand-written kernel of
``csrc/max_scan.cu`` (built at first use, see ops/build.py), with the
tile picked from the row length (:func:`_plan`); on a CPU tensor it runs
:func:`max_scan_plain`. There is no other route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import launch_on, load_library

__all__ = ["max_scan", "max_scan_plain", "max_scan_runs"]

_LIB = "max_scan"

#: the kernel's tiles in elements: a warp's (512) for a row that fits,
#: else a block of 8 warps (4,096), chained by the kernel's look-back in
#: a longer row (on an H100, 4,096 timed best at 100K and 1M against
#: 2,048 and 8,192)
_TILES = (512, 4096)

_DTYPES = {torch.int32: 0, torch.float32: 1}


def _bind(lib):
    fn = lib.max_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.max_scan_runs_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                       ctypes.c_int]
    lib.max_scan_runs_read.restype = ctypes.c_int


@functools.cache
def _library():
    return load_library(_LIB, _bind)


def _check(x):
    if not isinstance(x, torch.Tensor) or x.dtype not in _DTYPES:
        raise ValueError(f"max_scan takes an int32 or float32 tensor, not "
                         f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.dim() == 0 or not x.is_contiguous():
        raise ValueError(f"max_scan takes a contiguous tensor with at least "
                         f"one axis, not shape {tuple(x.shape)} with strides "
                         f"{x.stride()}")


def _plan(length: int, rows: int):
    """``(tile, tiles per row, scratch words)`` for ``rows`` rows of
    ``length``: the warp's tile where a row fits in it, else the block's;
    rows of more than one tile need the kernel's ticket counter and a
    status word per tile."""
    tile = _TILES[0] if length <= _TILES[0] else _TILES[1]
    per_row = max(1, -(-length // tile))
    return tile, per_row, rows * per_row + 1 if per_row > 1 else 0


def max_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`max_scan`."""
    _check(x)
    return torch.cummax(x, -1).values


def max_scan(x: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(x, -1).values``, bit for bit (see the module
    docstring). CPU tensors take the plain version; CUDA tensors launch
    the kernel, and a failed build or launch raises."""
    _check(x)
    if x.device.type == "cpu":
        return max_scan_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"max_scan runs on cpu or cuda tensors, not "
                         f"{x.device}")
    lib = _library()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    length = x.shape[-1]
    if y.numel() == 0:
        return y
    rows = x.numel() // length
    tile, _, words = _plan(length, rows)
    scratch = (torch.empty((words,), dtype=torch.int64, device=x.device)
               if words else None)
    err = launch_on(x.device, lib.max_scan, x.data_ptr(), y.data_ptr(), rows,
                    length, _DTYPES[x.dtype], tile,
                    None if scratch is None else scratch.data_ptr(), words)
    if err != 0:
        raise RuntimeError(f"max_scan launch failed: CUDA error {err}")
    max_scan.launches += 1
    return y


#: kernel launches made by :func:`max_scan` (under a capture: nodes
#: captured)
max_scan.launches = 0


def max_scan_runs(reset: bool = False) -> int:
    """How many times ``max_scan_kernel`` ran on the current card since the
    counter was last reset, a graph replay's runs included (the kernel
    counts itself); ``reset=True`` then sets the counter to 0.
    Synchronizes the card."""
    lib = _library()
    torch.cuda.synchronize()
    runs = ctypes.c_ulonglong(0)
    err = lib.max_scan_runs_read(ctypes.byref(runs), int(reset))
    if err != 0:
        raise RuntimeError(f"reading max_scan_kernel's counter failed: CUDA "
                           f"error {err}")
    return runs.value
