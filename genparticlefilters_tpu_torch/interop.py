"""Carry a filter state across from the JAX package, and back.

A state crosses as the list of its leaves in the JAX package's flattening
order (``jax.tree_util.tree_flatten(state)[0]``, each converted to a
numpy array by the caller). For the object-motion filter those are::

    args t, x0 y, x0 moving,            # the trace's shared args
    score [N] f32,
    carry y [N] f32, carry moving [N] bool,
    mat [T*R, N] i32, y_obs [T] f32,    # packed step storage (+ extras)
    t,                                  # active length
    log_weights [N] f32, log_ml_est f32, parents [N] i32

For the multi-object tracking filter (config 5; K objects, ``y``
observed densely and so stored shared, the ``[K, 2]`` carry kept in the
store rather than the scalar carry cache)::

    args t, x0 [K, 2] f32,               # the trace's shared args
    score [N] f32,
    mat [T*4K, N] i32, y [T, K, 2] f32,  # 16 rows per step at K=4
    t,                                   # active length
    log_weights [N] f32, log_ml_est f32, parents [N] i32

The data-association variant adds the ``[K]`` int32 ``assoc`` rows to
``mat`` (``T*5K`` rows). ``MOTParams`` holds no learned parameters; the
same values are passed to both packages.

For the stochastic-volatility filter (config 3; ``y`` observed densely,
stored shared)::

    args t i32, h0 f32,                  # the trace's shared args
    score [N] f32,
    carry h [N] f32,
    mat [2T, N] i32, y [T] f32,          # 2 rows per step: retval h, site h
    t,                                   # active length
    log_weights [N] f32, log_ml_est f32, parents [N] i32

For the tempered model (config 4; a plain ``@gen`` function, its sites
in sorted address order)::

    args beta f32,                       # shared
    retval x [N] f32, score [N] f32,
    site lik [N] f32 (the factor's zeros), site x [N] f32,
    log_weights [N] f32, log_ml_est f32, parents [N] i32

For the line model of tests/fixtures.py (a ``@gen`` trace whose
``inner["subs"]`` holds the Unfold called at ``"line"``; its sites, then
its sub-calls)::

    args n,                              # the model's shared args
    retval slope [N] i32, score [N] f32,
    site slope [N] i32,
    sub-call args n, x0 [N] f32, slope [N] f32,   # per particle at a
    sub-call score [N] f32,                       # sub-call position
    carry x [N] f32,
    mat [3T, N] i32,                     # retval x, site outlier, site y
    t,                                   # active length
    log_weights [N] f32, log_ml_est f32, parents [N] i32

``SVParams`` and the tempered constants hold no learned parameters either.

float32 leaves cross bit for bit and bool leaves as bool. The port's own
flattening (core/tree.py) has the same order, so the structure comes from
a template state built by the port itself. This module never sees JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.tree import tree_flatten, tree_unflatten
from .smc.initialize import pf_initialize
from .utils.device import entry_device

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(model, arrays, model_args, observations,
                     device="cuda"):
    """The port's ``ParticleFilterState`` of ``model`` holding ``arrays``
    (the JAX state's leaves as numpy arrays, in its order), on ``device``:
    the card unless the caller asks for the CPU (``device="cpu"``); with no
    card, the default raises. ``model_args`` and ``observations`` are those
    the state was initialized with: they fix which sites are stored shared,
    hence the storage layout."""
    arrays = list(arrays)
    device = entry_device(device, "state_from_numpy")
    n = int(np.shape(arrays[-3])[0])   # log_weights [N]
    gen = torch.Generator(device=device).manual_seed(0)
    template = pf_initialize(gen, model, model_args, observations, n)
    t_leaves, treedef = tree_flatten(template)
    if len(t_leaves) != len(arrays):
        raise ValueError(f"expected {len(t_leaves)} leaves, got "
                         f"{len(arrays)}")
    leaves = []
    for i, (a, ref) in enumerate(zip(arrays, t_leaves)):
        a = np.asarray(a)
        if not isinstance(ref, torch.Tensor):
            leaves.append(int(a))
            continue
        x = torch.from_numpy(np.array(a)).to(device)
        if x.dtype != ref.dtype or tuple(x.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: got {x.dtype} {tuple(x.shape)}, "
                             f"the port stores {ref.dtype} "
                             f"{tuple(ref.shape)}")
        leaves.append(x)
    return tree_unflatten(treedef, leaves)


def state_to_numpy(state):
    """The state's leaves as numpy arrays, in the JAX package's order
    (Python int leaves come back as int32 scalars)."""
    out = []
    for leaf in tree_flatten(state)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf.detach().cpu().numpy())
        else:
            out.append(np.asarray(leaf, dtype=np.int32))
    return out
