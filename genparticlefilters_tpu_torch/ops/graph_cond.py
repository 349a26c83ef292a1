"""The conditional-node shim (``csrc/graph_cond.cu``): XLA's ``conditional``
inside a CUDA graph being captured.

:func:`if_node` appends to the capture on ``pred``'s current stream a
one-thread kernel that hands ``pred`` (a one-element bool tensor on the
card) to a conditional handle, then an IF node with a THEN body, or a
THEN and an ELSE body, that depends on it, and makes the node the
stream's only dependency: what the stream captures next runs after the
node. It returns the body graphs. :func:`capture_body` captures what is
queued on a stream inside it into one of them
(``cudaStreamBeginCaptureToGraph``). At replay the THEN body runs where
``pred`` holds and the ELSE body, if any, where it does not; the
predicate is read on the card.

:func:`copy_leaves` is the bodies' one copy: ``dst.copy_(src)`` for every
pair in one launch of ``copy_leaves_kernel``; :func:`copy_leaves_plain` is
its plain version, a ``copy_`` per pair.

The IF node's plain version is ``smc/capture.py`` ``_select``: the same
function, both sides computed and ``torch.where`` choosing. A CPU tensor,
a stream that is not capturing, a runtime or driver older than CUDA 12.8
and a failed build all raise: there is no other route.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .build import launch_on, load_library

__all__ = ["if_node", "capture_body", "copy_leaves", "copy_leaves_plain",
           "copy_leaves_runs", "versions", "CAPTURE_MODE"]

_LIB = "graph_cond"

#: ``cudaStreamCaptureModeGlobal``: the mode of ``torch.cuda.graph``'s
#: default ``capture_error_mode="global"``, used for the bodies too
CAPTURE_MODE = 0


def _bind(lib):
    lib.graph_cond_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.graph_cond_versions.restype = ctypes.c_int
    lib.graph_cond_error.argtypes = [ctypes.c_int]
    lib.graph_cond_error.restype = ctypes.c_char_p
    lib.graph_cond_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.graph_cond_begin.restype = ctypes.c_int
    lib.copy_leaves.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
    lib.copy_leaves.restype = ctypes.c_int
    lib.copy_leaves_max.argtypes = []
    lib.copy_leaves_max.restype = ctypes.c_int
    lib.copy_leaves_runs_read.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    lib.copy_leaves_runs_read.restype = ctypes.c_int
    lib.graph_cond_body_begin.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.graph_cond_body_begin.restype = ctypes.c_int
    lib.graph_cond_body_end.argtypes = [ctypes.c_void_p]
    lib.graph_cond_body_end.restype = ctypes.c_int


def _lib():
    return load_library(_LIB, _bind)


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"graph_cond: {what} failed: "
                           f"{lib.graph_cond_error(err).decode()} ({err})")


def versions() -> dict:
    """``{"runtime", "driver"}``: the CUDA runtime the shim was built
    against and the driver's CUDA version, as 12080 for 12.8 (an ELSE body
    needs both at 12.8 or later; the build refuses an older toolkit)."""
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(2)]
    _check(lib, lib.graph_cond_versions(*[ctypes.byref(v) for v in vals]),
           "cudaRuntimeGetVersion / cudaDriverGetVersion")
    return dict(zip(("runtime", "driver"), (v.value for v in vals)))


def _device_pred(pred) -> torch.Tensor:
    if not isinstance(pred, torch.Tensor) or pred.device.type != "cuda":
        raise ValueError(
            f"graph_cond: a conditional node reads its predicate on the "
            f"card; got {getattr(pred, 'device', type(pred).__name__)} (on "
            f"the CPU, device_cond reads the predicate on the host)")
    if pred.numel() != 1:
        raise ValueError(f"graph_cond: the predicate must hold one element, "
                         f"got shape {tuple(pred.shape)}")
    return pred.reshape(()).to(torch.bool)


def if_node(pred: torch.Tensor, bodies: int = 2):
    """The body graphs, raw ``cudaGraph_t`` handles, of a new IF node
    captured on ``pred``'s current stream (see the module docstring):
    ``(then_graph,)`` for ``bodies=1``, ``(then_graph, else_graph)`` for
    ``bodies=2``. Raises where ``pred`` is not on the card or the stream
    is not capturing."""
    if bodies not in (1, 2):
        raise ValueError(f"graph_cond: an IF node has 1 or 2 bodies, not "
                         f"{bodies!r}")
    pred = _device_pred(pred)
    lib = _lib()
    graphs = (ctypes.c_void_p * bodies)()
    _check(lib, launch_on(pred.device, lib.graph_cond_begin, pred.data_ptr(),
                          ctypes.cast(graphs, ctypes.c_void_p), bodies),
           "building the IF node")
    if_node.launches += 1
    return tuple(graphs)


#: IF nodes made by :func:`if_node` (each launches its setter kernel at
#: every replay)
if_node.launches = 0


@contextlib.contextmanager
def capture_body(graph, stream: torch.cuda.Stream):
    """Capture the work queued on ``stream`` inside the block into the
    body ``graph`` (one of :func:`if_node`'s). An error inside the block
    propagates after the body's capture is closed; a capture that the
    driver invalidated raises on exit."""
    lib = _lib()
    handle = ctypes.c_void_p(stream.cuda_stream)
    _check(lib, lib.graph_cond_body_begin(graph, CAPTURE_MODE, handle),
           "cudaStreamBeginCaptureToGraph")
    try:
        yield
    except BaseException:
        lib.graph_cond_body_end(handle)
        raise
    _check(lib, lib.graph_cond_body_end(handle),
           "capturing the body (cudaStreamEndCapture)")


def _copy_pairs(dsts, srcs):
    """The pairs as lists, after checking that they match: as many
    destinations as sources, and each pair tensors of one shape and
    dtype."""
    dsts, srcs = list(dsts), list(srcs)
    if len(dsts) != len(srcs):
        raise ValueError(f"copy_leaves: {len(dsts)} destinations, "
                         f"{len(srcs)} sources")
    for i, (d, s) in enumerate(zip(dsts, srcs)):
        if not (isinstance(d, torch.Tensor) and isinstance(s, torch.Tensor)):
            raise TypeError(f"copy_leaves: pair {i} is not two tensors")
        if (d.shape, d.dtype) != (s.shape, s.dtype):
            raise ValueError(f"copy_leaves: pair {i} copies {s.dtype} "
                             f"{tuple(s.shape)} into {d.dtype} "
                             f"{tuple(d.shape)}")
    return dsts, srcs


def copy_leaves(dsts, srcs):
    """``dst.copy_(src)`` for each pair of ``dsts`` and ``srcs``, in one
    launch of ``copy_leaves_kernel`` on the current stream (one more per
    ``copy_leaves_max()`` pairs past the first). Each pair is two
    contiguous tensors of one shape and dtype on one card, not
    overlapping; anything else raises, a CPU tensor included."""
    dsts, srcs = _copy_pairs(dsts, srcs)
    if not dsts:
        return
    device = dsts[0].device
    for i, (d, s) in enumerate(zip(dsts, srcs)):
        if not (d.is_contiguous() and s.is_contiguous()):
            raise ValueError(f"copy_leaves: pair {i} is not contiguous "
                             f"(strides {s.stride()} -> {d.stride()})")
        if d.device.type != "cuda" or s.device != d.device or (
                d.device != device):
            raise ValueError(f"copy_leaves: pair {i} lies on {s.device} -> "
                             f"{d.device}; the kernel copies on one card "
                             f"({device}); copy_leaves_plain copies "
                             f"anywhere")
    lib = _lib()
    step = lib.copy_leaves_max()
    for lo in range(0, len(dsts), step):
        pairs = [(d, s) for d, s in zip(dsts[lo:lo + step], srcs[lo:lo + step])
                 if d.numel()]
        if not pairs:
            continue
        n = len(pairs)
        dst = (ctypes.c_void_p * n)(*(d.data_ptr() for d, _ in pairs))
        src = (ctypes.c_void_p * n)(*(s.data_ptr() for _, s in pairs))
        nbytes = (ctypes.c_longlong * n)(
            *(d.numel() * d.element_size() for d, _ in pairs))
        _check(lib, launch_on(device, lib.copy_leaves,
                              ctypes.cast(dst, ctypes.c_void_p),
                              ctypes.cast(src, ctypes.c_void_p),
                              ctypes.cast(nbytes, ctypes.c_void_p), n),
               "copy_leaves")
        copy_leaves.launches += 1


#: launches of ``copy_leaves_kernel`` (under a capture: nodes captured)
copy_leaves.launches = 0


def copy_leaves_runs(reset: bool = False) -> int:
    """How many times ``copy_leaves_kernel`` ran on the current card since
    the counter was last reset, a graph replay's runs included (the
    kernel counts itself); ``reset=True`` then sets the counter to 0.
    Synchronizes the card."""
    lib = _lib()
    torch.cuda.synchronize()
    runs = ctypes.c_ulonglong(0)
    _check(lib, lib.copy_leaves_runs_read(ctypes.byref(runs), int(reset)),
           "reading copy_leaves_kernel's counter")
    return runs.value


def copy_leaves_plain(dsts, srcs):
    """:func:`copy_leaves`' plain version: ``dst.copy_(src)`` per pair,
    on any device."""
    for d, s in zip(*_copy_pairs(dsts, srcs)):
        d.copy_(s)
