"""The conditional-node shim (``csrc/graph_cond.cu``): XLA's ``conditional``
inside a CUDA graph being captured.

:func:`if_node` appends to the capture on ``pred``'s current stream a
one-thread kernel that hands ``pred`` (a one-element bool tensor on the
card) to a conditional handle, then an IF node with a THEN and an ELSE
body that depends on it, and makes the node the stream's only dependency:
what the stream captures next runs after the node. It returns the two
body graphs. :func:`capture_body` captures what is queued on a stream
inside it into one of them (``cudaStreamBeginCaptureToGraph``). At replay
the THEN body runs where ``pred`` holds and the ELSE body where it does
not; the predicate is read on the card.

The plain version is ``smc/capture.py`` ``_select``: the same function,
both sides computed and ``torch.where`` choosing. A CPU tensor, a stream
that is not capturing, a runtime or driver without ELSE bodies (CUDA 12.8)
and a failed build all raise: there is no other route.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .build import launch_on, load_library

__all__ = ["if_node", "capture_body", "versions", "CAPTURE_MODE"]

_LIB = "graph_cond"

#: ``cudaStreamCaptureModeGlobal``: the mode of ``torch.cuda.graph``'s
#: default ``capture_error_mode="global"``, used for the bodies too
CAPTURE_MODE = 0


def _bind(lib):
    lib.graph_cond_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.graph_cond_versions.restype = ctypes.c_int
    lib.graph_cond_error.argtypes = [ctypes.c_int]
    lib.graph_cond_error.restype = ctypes.c_char_p
    lib.graph_cond_begin.argtypes = [ctypes.c_void_p] * 3
    lib.graph_cond_begin.restype = ctypes.c_int
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


def if_node(pred: torch.Tensor):
    """``(then_graph, else_graph)``, raw ``cudaGraph_t`` handles of a new
    IF node captured on ``pred``'s current stream (see the module
    docstring). Raises where ``pred`` is not on the card or the stream is
    not capturing."""
    pred = _device_pred(pred)
    lib = _lib()
    bodies = (ctypes.c_void_p * 2)()
    _check(lib, launch_on(pred.device, lib.graph_cond_begin, pred.data_ptr(),
                          ctypes.cast(bodies, ctypes.c_void_p)),
           "building the IF node")
    if_node.launches += 1
    return bodies[0], bodies[1]


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
