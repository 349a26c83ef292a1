"""Stratification: ``choiceproduct`` and the stratum of each particle.

N particle indices are split over K strata either in ``contiguous``
blocks of B = N//K or ``interleaved`` with stride K; the remainder
R = N − K·B (the tail indices) get uniformly random strata. The strata
choicemaps are stacked into one map with a leading [K] axis and gathered
by the [N] assignment, giving per-particle constraints for one batched
interpretation.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence

import torch

from ..core.choicemap import ChoiceMap, Entry, choicemap, value_on

__all__ = ["choiceproduct", "stratum_assignment", "stack_strata",
           "gather_strata"]


def choiceproduct(*choices) -> List[ChoiceMap]:
    """Cartesian product of ``(addr, vals)`` tuples (or one dict) as a list
    of ChoiceMaps."""
    if len(choices) == 1 and isinstance(choices[0], dict):
        items = list(choices[0].items())
    else:
        items = [(addr, vals) for addr, vals in choices]
    pools = [[(addr, v) for v in vals] for addr, vals in items]
    return [choicemap(*combo) for combo in itertools.product(*pools)]


def stratum_assignment(gen, n_total: int, n_strata: int,
                       layout: str = "contiguous", assignment_tail=None):
    """Per-particle stratum indices ``[n_total]`` int32 on ``gen``'s device.

    The first K·(N//K) indices are assigned by index arithmetic alone; the
    remaining tail draws uniform strata from ``gen``, or takes them from
    ``assignment_tail`` (``[N − K·(N//K)]`` ints), the seam through which
    tests feed both packages the same draws."""
    if layout not in ("contiguous", "interleaved"):
        raise ValueError(f"unknown layout {layout!r}")
    device = gen.device
    block = n_total // n_strata
    n_main = n_strata * block
    idx = torch.arange(n_main, dtype=torch.int32, device=device)
    base = idx // max(block, 1) if layout == "contiguous" else idx % n_strata
    base = torch.clamp_max(base, n_strata - 1)
    if assignment_tail is not None:
        tail = torch.as_tensor(assignment_tail, device=device).to(torch.int32)
        if tuple(tail.shape) != (n_total - n_main,):
            raise ValueError(f"assignment_tail has shape "
                             f"{tuple(tail.shape)}, want "
                             f"({n_total - n_main},)")
    else:
        tail = torch.randint(0, n_strata, (n_total - n_main,), generator=gen,
                             device=device, dtype=torch.int32)
    return torch.cat([base, tail])


def stack_strata(strata: Sequence[ChoiceMap], device) -> ChoiceMap:
    """Stack K structurally identical choicemaps into one with a leading
    [K] axis on every entry value, on ``device`` (masks must be static
    True)."""
    strata = list(strata)
    entries = {}
    for k in strata[0].entries:
        entries[k] = Entry(torch.stack([
            value_on(s.entries[k].value, device) for s in strata]), True)
    return ChoiceMap(entries)


def gather_strata(stacked: ChoiceMap, assignment) -> ChoiceMap:
    """Per-particle constraints: the stacked strata indexed by the [N]
    assignment, giving entries with a leading particle axis."""
    idx = assignment.long()
    return ChoiceMap({k: Entry(torch.index_select(e.value, 0, idx), True)
                      for k, e in stacked.entries.items()})
