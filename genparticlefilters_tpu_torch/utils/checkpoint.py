"""Checkpoint / resume for particle filter states.

A :class:`~..smc.state.ParticleFilterState` is a tree (core/tree.py) of
tensors and a few Python scalars (an Unfold's active length). A
checkpoint is one ``torch.save`` file of plain data: the non-empty tensor
leaves in flattening order, moved to the CPU, and a JSON metadata record
(format version, leaf count, shapes and dtypes, the scalar leaves).
:func:`restore_state` loads it with ``weights_only=True``, checks it
against ``like`` — the state of a freshly initialized filter of the same
model and particle count — and rebuilds ``like``'s structure on
``like``'s device. Zero-size leaves (the slimmed step-score placeholders)
carry no data and come from ``like``.
"""

from __future__ import annotations

import json
from typing import Any

import torch

from ..core.tree import tree_flatten, tree_unflatten

__all__ = ["save_state", "restore_state", "FORMAT_VERSION"]

#: bump on any change to the on-disk layout
FORMAT_VERSION = 1

_SCALARS = (bool, int, float)


def _data(leaves):
    return [x for x in leaves if isinstance(x, torch.Tensor) and x.numel()]


def save_state(path: str, state) -> None:
    """Save a state (or any tree of tensors and Python scalars) to
    ``path``. The tensors are copied to the CPU first (a read of the
    device)."""
    leaves, _ = tree_flatten(state)
    data = _data(leaves)
    meta = {
        "format_version": FORMAT_VERSION,
        "n_leaves": len(data),
        "shapes": [list(x.shape) for x in data],
        "dtypes": [str(x.dtype) for x in data],
        "scalars": [[i, x] for i, x in enumerate(leaves)
                    if isinstance(x, _SCALARS)],
    }
    torch.save({"meta": json.dumps(meta),
                "tensors": [x.detach().cpu() for x in data]}, path)


def _check_meta(meta: dict, expected) -> None:
    """The metadata record against ``like``'s non-empty tensor leaves."""
    v = meta.get("format_version")
    if not isinstance(v, int) or v > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format_version {v!r} is newer than this library's "
            f"{FORMAT_VERSION}; upgrade genparticlefilters_tpu_torch to "
            f"restore it")
    if meta.get("n_leaves") != len(expected):
        raise ValueError(
            f"checkpoint is incompatible with `like`: it holds "
            f"{meta.get('n_leaves')} data leaves but the provided structure "
            f"expects {len(expected)} (different model, horizon, or library "
            "version)")
    for i, (shp, dt, exp) in enumerate(zip(meta["shapes"], meta["dtypes"],
                                           expected)):
        if tuple(shp) != tuple(exp.shape):
            raise ValueError(
                f"checkpoint leaf {i} has shape {tuple(shp)} but `like` "
                f"expects {tuple(exp.shape)} (different particle count, "
                "horizon, or model)")
        if dt != str(exp.dtype):
            raise ValueError(
                f"checkpoint leaf {i} has dtype {dt} but `like` expects "
                f"{exp.dtype} (different model or library version)")


def restore_state(path: str, like) -> Any:
    """Restore a state saved by :func:`save_state` in the structure of
    ``like`` and on its device. Raises ``ValueError`` when the
    checkpoint's format version, leaf count, shapes or dtypes do not match
    ``like``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    meta = json.loads(blob["meta"])
    leaves, treedef = tree_flatten(like)
    expected = _data(leaves)
    _check_meta(meta, expected)
    scalars = {i: x for i, x in meta["scalars"]}
    it = iter(blob["tensors"])
    out = []
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor) and x.numel():
            out.append(next(it).to(x.device))
        elif i in scalars and isinstance(x, _SCALARS):
            out.append(type(x)(scalars[i]))
        else:
            out.append(x)
    return tree_unflatten(treedef, out)
