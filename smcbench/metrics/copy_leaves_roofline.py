"""copy_leaves_roofline: ``copy_leaves_kernel`` (``csrc/graph_cond.cu``,
the copy-back of a taken ESS branch) on the cell's own replaced leaf set,
as a share of its bandwidth bound, in %: each source read once and each
destination written once, over the card's peak bandwidth, over its device
time alone with the L2 cache flushed before each call.

The traced run records the leaf sets the captured IF bodies copy; the
largest is timed. Nothing in an eager cell."""

import torch

from smcbench.harness.devicetime import flushed_seconds, bandwidth_share


def copy_bytes(leaves) -> int:
    """``leaves``: ``[(shape, dtype)]``; each read once and written once."""
    return 2 * sum(torch.Size(s).numel() * torch.empty((), dtype=d).itemsize
                   for s, d in leaves)


class _Recorder:
    """``copy_leaves`` that notes each leaf set it is handed; its
    ``launches`` counter is the wrapped function's, which the wrapped
    function itself increments through the module's name."""

    def __init__(self, inner, sets):
        self.inner, self.sets = inner, sets

    def __call__(self, dsts, srcs):
        dsts, srcs = list(dsts), list(srcs)
        self.sets.append(tuple((tuple(d.shape), d.dtype) for d in dsts))
        return self.inner(dsts, srcs)

    @property
    def launches(self):
        return self.inner.launches

    @launches.setter
    def launches(self, value):
        self.inner.launches = value


def prepare(rec):
    from genparticlefilters_tpu_torch.ops import graph_cond
    inner = graph_cond.copy_leaves
    graph_cond.copy_leaves = _Recorder(
        inner, rec.notes.setdefault("copy_leaves", []))

    def undo():
        graph_cond.copy_leaves = inner
    return undo


def read(rec):
    sets = rec.notes.get("copy_leaves")
    if rec.device.type != "cuda" or not sets:
        return None
    from genparticlefilters_tpu_torch.ops.graph_cond import copy_leaves
    leaves = max(sets, key=copy_bytes)
    srcs = [torch.zeros(s, dtype=d, device=rec.device) for s, d in leaves]
    dsts = [torch.empty_like(x) for x in srcs]
    seconds = flushed_seconds(lambda: copy_leaves(dsts, srcs), rec.device)
    rec.notes["copy_leaves_timed"] = {"leaves": len(leaves),
                                      "bytes": copy_bytes(leaves),
                                      "seconds": seconds}
    return bandwidth_share(copy_bytes(leaves), seconds, rec.device)
