"""g1_roofline: G1 (``resample_gather_split``, ``csrc/stairs_gather.cu``)
at the cell's own piece widths and particle count, as a share of its
bandwidth bound, in %: the least bytes it must move (each input read once,
each output written once) over the card's peak bandwidth, over its device
time alone with the L2 cache flushed before each call.

The traced run records the widths G1 is handed while the filter is set
up (captured, or run eagerly); nothing where it is never called."""

import torch

from smcbench.harness.devicetime import flushed_seconds, bandwidth_share


def g1_bytes(widths, n: int, m: int) -> int:
    """Pieces [w, n] int32 read, outputs [w, m] written, the hit counts
    F [n] read, the parents [m] written."""
    rows = sum(widths)
    return 4 * (rows * n + rows * m + n + m)


def prepare(rec):
    from genparticlefilters_tpu_torch.smc import resample
    inner = resample.resample_gather_split
    calls = rec.notes.setdefault("g1", [])

    def recorder(pieces, F, n_out=None):
        pieces = list(pieces)
        calls.append((tuple(p.shape[0] for p in pieces), F.shape[0],
                      F.shape[0] if n_out is None else int(n_out)))
        return inner(pieces, F, n_out=n_out)
    resample.resample_gather_split = recorder

    def undo():
        resample.resample_gather_split = inner
    return undo


def _inputs(widths, n, m, device):
    """Random pieces and systematic hit counts of random weights."""
    gen = torch.Generator(device=device).manual_seed(0)
    pieces = [torch.randint(-2 ** 31, 2 ** 31 - 1, (w, n), generator=gen,
                            device=device, dtype=torch.int32)
              for w in widths]
    w = torch.softmax(torch.randn(n, generator=gen, device=device), 0)
    c = torch.cumsum(w.double(), 0)
    u0 = torch.rand((), generator=gen, device=device, dtype=torch.float64)
    F = (torch.floor(m * c - u0) + 1).clamp_(0, m).to(torch.int32)
    F[-1] = m
    return pieces, F


def read(rec):
    calls = rec.notes.get("g1")
    if rec.device.type != "cuda" or not calls:
        return None
    from genparticlefilters_tpu_torch.ops.fused_gather import (
        resample_gather_split)
    widths, n, m = max(set(calls), key=calls.count)
    pieces, F = _inputs(widths, n, m, rec.device)
    seconds = flushed_seconds(
        lambda: resample_gather_split(pieces, F, n_out=m), rec.device)
    rec.notes["g1_timed"] = {"widths": widths, "n": n, "m": m,
                             "seconds": seconds}
    return bandwidth_share(g1_bytes(widths, n, m), seconds, rec.device)
