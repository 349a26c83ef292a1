"""The ESS check: whether the effective sample size of a vector of log
weights lies below a threshold, as one kernel.

``ess_below(log_weights, threshold)`` returns a one-element bool tensor,
``ess_from_log_weights(log_weights) < threshold``: false wherever that ESS
is NaN (a NaN or +inf weight, every weight -inf). ``threshold`` is a
Python number, rounded to float32 as a tensor-vs-scalar compare rounds
it; under a capture it is baked into the graph's node.

On a CUDA tensor it launches the hand-written kernel of
``csrc/ess_check.cu`` (built at first use, see ops/build.py): one pass,
one graph node, the grid picked from the length (:func:`_blocks`). It takes a contiguous 1-D float32 tensor and raises on
anything else. On a CPU tensor it runs :func:`ess_below_plain`, the
chain of PyTorch calls it replaces. There is no other route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.weights import ess_from_log_weights
from .build import launch_on, load_library

__all__ = ["ess_below", "ess_below_plain", "ess_check_runs"]

_LIB = "ess_check"

#: the kernel's blocks (512 threads each): this many elements a block, 8
#: a thread, up to the kernel's 1,024 blocks (100K: 25 blocks, 1M: 245;
#: on an H100, 4,096 timed best at 100K and 1M against 1,024, 2,048 and
#: 8,192)
_PER_BLOCK = 4096
_MAX_BLOCKS = 1024


def _bind(lib):
    fn = lib.ess_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ess_check_runs_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                        ctypes.c_int]
    lib.ess_check_runs_read.restype = ctypes.c_int


@functools.cache
def _library():
    return load_library(_LIB, _bind)


def _blocks(n: int) -> int:
    """The kernel's blocks for ``n`` log weights: from the length alone,
    so that a check's fold order, and its bits, never depend on the
    card."""
    return max(1, min(_MAX_BLOCKS, -(-n // _PER_BLOCK)))


def _check(x):
    if x.dtype != torch.float32:
        raise ValueError(f"ess_below takes float32 log weights on the card, "
                         f"not {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"ess_below takes a contiguous 1-D tensor on the "
                         f"card, not shape {tuple(x.shape)} with strides "
                         f"{x.stride()}")


def ess_below_plain(log_weights: torch.Tensor, threshold, *,
                    with_ess: bool = False):
    """The plain PyTorch version of :func:`ess_below`: ESS by
    ``utils/weights.py`` ``ess_from_log_weights``, then the compare."""
    ess = ess_from_log_weights(log_weights)
    low = ess < threshold
    return (low, ess) if with_ess else low


def ess_below(log_weights: torch.Tensor, threshold, *,
              with_ess: bool = False):
    """``ess_from_log_weights(log_weights) < threshold`` as a one-element
    bool tensor (see the module docstring); with ``with_ess``, also the
    ESS, a float32 scalar tensor. CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a failed build or launch raises."""
    if not isinstance(log_weights, torch.Tensor):
        raise ValueError(f"ess_below takes a tensor of log weights, not "
                         f"{type(log_weights).__name__}")
    if log_weights.device.type == "cpu":
        return ess_below_plain(log_weights, threshold, with_ess=with_ess)
    _check(log_weights)
    if log_weights.device.type != "cuda":
        raise ValueError(f"ess_below runs on cpu or cuda tensors, not "
                         f"{log_weights.device}")
    thr = float(threshold)
    lib = _library()
    n = log_weights.shape[0]
    low = torch.empty((), dtype=torch.bool, device=log_weights.device)
    ess = (torch.empty((), dtype=torch.float32, device=log_weights.device)
           if with_ess else None)
    err = launch_on(log_weights.device, lib.ess_check,
                    log_weights.data_ptr(), n, thr, _blocks(n),
                    low.data_ptr(), None if ess is None else ess.data_ptr())
    if err != 0:
        raise RuntimeError(f"ess_check launch failed: CUDA error {err}")
    ess_below.launches += 1
    return (low, ess) if with_ess else low


#: kernel launches made by :func:`ess_below` (under a capture: nodes
#: captured)
ess_below.launches = 0


def ess_check_runs(reset: bool = False) -> int:
    """How many times ``ess_check_kernel`` ran on the current card since
    the counter was last reset, a graph replay's runs included (the
    kernel counts itself); ``reset=True`` then sets the counter to 0.
    Synchronizes the card."""
    lib = _library()
    torch.cuda.synchronize()
    runs = ctypes.c_ulonglong(0)
    err = lib.ess_check_runs_read(ctypes.byref(runs), int(reset))
    if err != 0:
        raise RuntimeError(f"reading ess_check_kernel's counter failed: CUDA "
                           f"error {err}")
    return runs.value
