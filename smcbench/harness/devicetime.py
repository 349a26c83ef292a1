"""A kernel's device time alone, with the L2 cache flushed between calls,
and the card's peaks that a roofline share is taken against."""

from __future__ import annotations

import statistics

import torch

#: published peaks by ``torch.cuda.get_device_name()``: device-memory
#: bytes/s (NVIDIA's H100 SXM data sheet; at the 700 W power limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}

#: read before each timed call: well past the H100's 50 MB L2, so the
#: call finds none of its inputs there, and no dirty line of the flush's
#: own to write back while it runs
FLUSH_BYTES = 256 << 20


def flushed_seconds(fn, device, calls: int = 30) -> float:
    """Median device seconds of ``fn()`` over ``calls`` calls, each timed
    alone by CUDA events around it after a read of ``FLUSH_BYTES``."""
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    fn()
    pairs = []
    for _ in range(calls):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / 1e3


def bandwidth_share(nbytes: float, seconds: float, device) -> float | None:
    """``nbytes`` over the card's peak bandwidth, over ``seconds``, in %;
    None on a card the table does not know."""
    peak = PEAKS.get(torch.cuda.get_device_name(device))
    if peak is None:
        return None
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / seconds
