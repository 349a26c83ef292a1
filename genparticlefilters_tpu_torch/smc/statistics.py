"""Weighted posterior statistics over a choice address."""

from __future__ import annotations

import torch

from .state import get_norm_weights, batched_choice

__all__ = ["mean"]


def mean(state, addr):
    """Weighted empirical mean of the choice at ``addr`` (e.g.
    ``(t, "moving")``); a float32 device tensor."""
    w = get_norm_weights(state)
    v = batched_choice(state, addr).to(torch.float32)
    return torch.sum(w.reshape(w.shape + (1,) * (v.dim() - 1)) * v, dim=0)
