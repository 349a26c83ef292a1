"""Blockwise (shard-local) resampling and block exchange, on one device
or across the ranks of a particle mesh.

Sub-state resampling semantics (keep each block's total weight, never
touch the global LML) are the specification of shard-local resampling:
:func:`pf_resample_blockwise` resamples each of ``n_blocks`` contiguous
blocks of the particle axis independently. On one device:

- with no ``priority_fn``, systematic, residual, multinomial and unsorted
  stratified take ONE fused gather for all blocks, the per-block offspring
  structures composed globally by ``smc.resample.blockwise_compose``: G1
  for systematic and residual, G2 for multinomial and unsorted stratified;
- with a ``priority_fn``, or for sorted stratified, each block's explicit
  parents are offset into one global vector and gathered by G3.

:func:`pf_rotate_blocks` and :func:`pf_shuffle_blocks` move whole blocks or
equal slices of them, the exchange that bounds the weight imbalance
between shards; on one device each is one permutation gathered by G3.

With a ``mesh`` (parallel/mesh.py; the state sharded over it, one block
per rank) every verb works on this rank's block and gives exactly the
result of the one-device form on the whole state, given the same draws:

- :func:`pf_resample_blockwise` makes no collective call: each rank draws
  what the one-device form draws for all ``n_blocks`` blocks, keeps its
  own row and runs the same fused G1/G2 gather (or G3) on its block;
- :func:`pf_rotate_blocks` is one ring of point-to-point sends and
  receives per leaf (``batch_isend_irecv``);
- :func:`pf_shuffle_blocks` is one ``all_to_all_single`` per leaf.

A sharded state passed without a mesh uses its own.
"""

from __future__ import annotations

import torch

from ..smc.resample import (multinomial_parents, residual_parents,
                            stratified_parents, systematic_parents,
                            blockwise_compose, _gather_traces,
                            _gather_traces_from_F, _gather_traces_from_cu,
                            _new_weights_sub)
from ..core.tree import tree_unflatten
from ..smc.state import ParticleFilterState
from ..utils.weights import safe_softmax, logsumexp, log_float32
from . import mesh as pm
from .mesh import ParticleMesh, _particle_axes

__all__ = ["pf_resample_blockwise", "pf_shuffle_blocks", "pf_rotate_blocks",
           "block_log_weight_imbalance"]

# ``d``: the block's draws (:func:`_block_draws`)
_PARENT_FNS = {
    "multinomial": lambda g, w, lp, **d: multinomial_parents(g, w, **d),
    "residual": lambda g, w, lp, **d: residual_parents(g, w, **d),
    "stratified": lambda g, w, lp, **d: stratified_parents(
        g, w, log_priorities=lp, **d),
    "systematic": lambda g, w, lp, **d: systematic_parents(
        g, w, log_priorities=lp, **d),
}

_FUSED = ("systematic", "multinomial", "residual", "stratified_unsorted")


def _check_blocks(state, n_blocks: int, mesh):
    """The mesh the verb runs on (``mesh``, else the state's own) after
    the checks: a mesh is a :class:`ParticleMesh` with ``n_blocks`` ranks
    and the state is sharded over it. Returns ``(mesh, n)``, ``n`` the
    global particle count."""
    mesh = getattr(state, "mesh", None) if mesh is None else mesh
    n = state.n_particles
    if mesh is not None:
        if not isinstance(mesh, ParticleMesh):
            raise TypeError(f"mesh must be a ParticleMesh (parallel."
                            f"particle_mesh), got {type(mesh).__name__}")
        if mesh.size != n_blocks:
            raise ValueError(
                f"mesh axis {mesh.axis_name!r} has {mesh.size} devices but "
                f"n_blocks={n_blocks}")
        if getattr(state, "mesh", None) is not mesh:
            raise ValueError("the state is not sharded over this mesh: "
                             "shard_state(state, mesh) first")
        n *= mesh.size
    if n % n_blocks != 0:
        raise ValueError(f"n_particles={n} not divisible by {n_blocks}")
    return mesh, n


def _block_draws(gen, method, n_blocks, b, device):
    """The per-block draws of the explicit-parents route, block by block
    in order (the stream the one-device loop consumes): systematic one
    uniform, stratified ``b`` uniforms, multinomial and residual ``b + 1``
    exponentials."""
    def one():
        if method == "systematic":
            return {"u0": torch.rand((), generator=gen, dtype=torch.float32,
                                     device=device)}
        if method == "stratified":
            return {"v": torch.rand((b,), generator=gen,
                                    dtype=torch.float32, device=device)}
        return {"e": torch.empty((b + 1,), dtype=torch.float32,
                                 device=device).exponential_(generator=gen)}
    return [one() for _ in range(n_blocks)]


def pf_resample_blockwise(gen, state: ParticleFilterState, n_blocks: int,
                          method: str = "systematic", priority_fn=None,
                          mesh=None, sort_particles: bool | None = None
                          ) -> ParticleFilterState:
    """Resample independently inside each of ``n_blocks`` contiguous blocks
    of the particle axis, keeping each block's total weight (sub-state
    semantics); the LML estimate is untouched.

    ``sort_particles`` applies to ``method="stratified"`` only: the default
    (None/True) keeps the weight-sorted stratified draws on the per-block
    G3 route; ``False`` drops the pre-sort, the same stratified law with
    non-decreasing parents on the fused route. Every draw comes from
    ``gen``. With a ``mesh`` (``n_blocks`` ranks, the state sharded over
    it) each rank resamples its own block with no collective call: seeded
    alike on every rank, ``gen`` gives every block the draws the
    one-device form gives it."""
    mesh, n = _check_blocks(state, n_blocks, mesh)
    b = n // n_blocks
    if method not in _PARENT_FNS:
        raise ValueError(f"Resampling method {method!r} not recognized.")
    fused_key = method
    if method == "stratified" and sort_particles is False:
        fused_key = "stratified_unsorted"
        parent_fn = (lambda g, w, lp, **d: stratified_parents(
            g, w, log_priorities=lp, sort_particles=False, **d))
    else:
        parent_fn = _PARENT_FNS[method]
    custom = priority_fn is not None
    # the blocks this rank resamples: all of them, or its own
    first, n_local = (0, n_blocks) if mesh is None else (mesh.rank, 1)
    lw = state.log_weights.reshape(n_local, b)
    lp = priority_fn(lw) if custom else lw
    offset = first * b

    def done(new_traces, new_lw, parents):
        return ParticleFilterState(new_traces, new_lw, state.log_ml_est,
                                   (parents + offset).to(torch.int32),
                                   mesh=mesh)

    if not custom and fused_key in _FUSED:
        # ONE fused gather for the blocks: the per-block offspring
        # structures composed globally, the same offspring law as the
        # per-block route below (bit-identical for systematic)
        kind, payload = blockwise_compose(
            gen, safe_softmax(lp)[0],
            "stratified" if fused_key == "stratified_unsorted" else method,
            first_block=first, n_blocks=n_blocks)
        if kind == "cu":
            new_traces, parents = _gather_traces_from_cu(state.traces,
                                                         *payload)
        else:
            new_traces, parents = _gather_traces_from_F(state.traces,
                                                        payload - offset)
        avg = torch.logsumexp(lw, 1) - log_float32(b, lw.device)
        return done(new_traces, avg[:, None].expand(n_local, b)
                    .reshape(n_local * b), parents)

    # per-block explicit parents, offset into one vector, one G3 gather
    draws = _block_draws(gen, "stratified" if fused_key.startswith(
        "stratified") else method, n_blocks, b, lw.device)
    local, new_lw = [], []
    for k in range(n_local):
        w, _ = safe_softmax(lp[k])
        par = parent_fn(gen, w, lp[k], **draws[first + k])
        local.append(par.to(torch.int32) + k * b)
        new_lw.append(_new_weights_sub(b, lw[k], lp[k], par, custom))
    parents = torch.cat(local)
    return done(_gather_traces(state.traces, parents), torch.cat(new_lw),
                parents)


def _apply_perm(state: ParticleFilterState, perm) -> ParticleFilterState:
    perm = perm.to(torch.int32).contiguous()
    return ParticleFilterState(
        _gather_traces(state.traces, perm),
        torch.index_select(state.log_weights, 0, perm.long()),
        state.log_ml_est, perm)


def pf_shuffle_blocks(state: ParticleFilterState, n_blocks: int,
                      mesh=None) -> ParticleFilterState:
    """Deterministic equal-split block transpose: new block i holds the
    ``b/K`` particles ``[j*b + i*(b/K), j*b + (i+1)*(b/K))`` of every old
    block j (requires ``n_blocks**2 | n``): new ``(i, j*c + r)`` holds old
    ``(j, i*c + r)``. One G3 gather of that permutation; on a mesh one
    ``all_to_all_single`` per leaf, each rank keeping ``1/K`` of its
    particles."""
    mesh, n = _check_blocks(state, n_blocks, mesh)
    K = n_blocks
    b = n // K
    if b % K != 0:
        raise ValueError(
            f"shuffle needs equal splits: block size {b} not divisible by "
            f"n_blocks={K}")
    c = b // K
    dev = state.log_weights.device
    if mesh is not None:
        parents = (torch.arange(K, dtype=torch.int32, device=dev)[:, None]
                   * b + mesh.rank * c
                   + torch.arange(c, dtype=torch.int32, device=dev)[None]
                   ).reshape(b)

        def move(x, ax):
            y = torch.movedim(x, ax, 0)
            y = pm.all_to_all(y, b, [c] * K, [c] * K, mesh)
            return torch.movedim(y, 0, ax).contiguous()
        leaves, treedef, axes = _particle_axes(state.traces, b)
        for i, ax in enumerate(axes):
            if ax is not None:
                leaves[i] = move(leaves[i], ax)
        return ParticleFilterState(tree_unflatten(treedef, leaves),
                                   move(state.log_weights, 0),
                                   state.log_ml_est, parents, mesh=mesh)
    perm = torch.arange(n, dtype=torch.int32, device=dev).reshape(K, K, c)
    return _apply_perm(state, perm.permute(1, 0, 2).reshape(n))


def pf_rotate_blocks(state: ParticleFilterState, n_blocks: int,
                     shift: int = 1, mesh=None) -> ParticleFilterState:
    """Ring-rotate whole blocks by ``shift``: block j's particles move to
    block ``(j + shift) mod K``. One G3 gather of that permutation; on a
    mesh one ring of sends and receives per leaf."""
    mesh, n = _check_blocks(state, n_blocks, mesh)
    b = n // n_blocks
    dev = state.log_weights.device
    if mesh is not None:
        src = (mesh.rank - shift) % n_blocks
        parents = src * b + torch.arange(b, dtype=torch.int32, device=dev)
        leaves, treedef, axes = _particle_axes(state.traces, b)
        moving = [i for i, ax in enumerate(axes) if ax is not None]
        moved = pm.ring([leaves[i] for i in moving] + [state.log_weights],
                        shift, mesh)
        for i, x in zip(moving, moved):
            leaves[i] = x
        return ParticleFilterState(tree_unflatten(treedef, leaves),
                                   moved[-1], state.log_ml_est, parents,
                                   mesh=mesh)
    blocks = torch.arange(n, dtype=torch.int32, device=dev).reshape(
        n_blocks, n // n_blocks)
    return _apply_perm(state, torch.roll(blocks, shifts=shift,
                                         dims=0).reshape(n))


def block_log_weight_imbalance(state: ParticleFilterState, n_blocks: int):
    """max − min of the per-block total log weight: the trigger diagnostic
    for a block exchange (over every rank's blocks for a sharded state:
    one all-gather)."""
    mesh = getattr(state, "mesh", None)
    K = 1 if mesh is None else mesh.size
    b = state.n_particles * K // n_blocks
    totals = logsumexp(state.log_weights.reshape(-1, b))
    if mesh is not None:
        totals = pm.all_gather(totals, mesh)
    return torch.max(totals) - torch.min(totals)
