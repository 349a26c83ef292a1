"""Particle meshes and sharded particle states on ``torch.distributed``.

PyTorch runs SPMD: one process per card. A mesh is a process group over
the ranks that share the particle axis, and a sharded state is the block of
the particle axis this rank holds — exactly a
:class:`~..smc.state.ParticleFilterSubState` block, whose weight semantics
(keep the block's total weight, never touch the global LML) are the spec of
every shard-local operation. Each leaf is cut at its own particle axis (the
trace layout's spec: the time-major packed store ``mat [T*R, N]`` is cut on
axis 1); leaves shared across particles and the LML are replicated.

A sharded state knows its mesh (``state.mesh``), and the global reductions
of the SMC layer all-gather across it: the ESS, the LML estimate and the
normalized weights (smc/state.py), the weighted statistics
(smc/statistics.py) and the exact global resample (smc/resample.py), so
every rank takes the same ESS branch. ``state.n_particles`` stays this
rank's count; :func:`~..smc.state.num_particles` gives the global one.

Every collective goes through the wrappers below and counts itself in
:data:`COLLECTIVES`, so a run can show which verbs talked across ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.batching import axes_spec
from ..core.tree import tree_flatten, tree_unflatten, flatten_up_to

__all__ = ["particle_mesh", "shard_state", "state_sharding",
           "state_pspecs", "replicated_sharding"]

PARTICLE_AXIS = "p"

#: collectives issued through this module, by kind (reset by the caller)
COLLECTIVES = {"all_gather": 0, "broadcast": 0, "all_to_all": 0,
               "ring": 0}


class ParticleMesh:
    """A 1-D mesh: the process group over ``ranks`` (global ranks, in
    particle-block order), this rank's index in it and the device its
    tensors live on (its card under NCCL, the CPU under gloo)."""

    __slots__ = ("group", "ranks", "rank", "size", "axis_name", "device")

    def __init__(self, group, ranks, axis_name, device):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.axis_name = axis_name
        self.device = torch.device(device)

    def __repr__(self):
        return (f"ParticleMesh({self.axis_name!r}: {self.size} ranks, "
                f"rank {self.rank}, {self.device})")


def particle_mesh(devices=None, axis_name: str = PARTICLE_AXIS
                  ) -> ParticleMesh:
    """A 1-D particle mesh over every rank of the default process group,
    or over the global ranks ``devices`` (every rank calls this, as it
    creates a group). ``torch.distributed`` must be initialized: give
    ``init_process_group`` its address (``tcp://localhost:<port>`` or
    ``file://<path>``), world size and rank. Under NCCL a rank's tensors
    live on its current card."""
    if not dist.is_initialized():
        raise RuntimeError(
            "particle_mesh needs torch.distributed: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) on every rank first")
    world = dist.get_world_size()
    if devices is None:
        ranks, group = list(range(world)), dist.group.WORLD
    else:
        ranks = [int(r) for r in devices]
        group = dist.new_group(ranks)
        if dist.get_rank() not in ranks:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{ranks}")
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return ParticleMesh(group, ranks, axis_name, device)


class PartitionSpec:
    """Where a leaf's axes are split over the mesh: one entry per leading
    axis, the mesh axis name at the particle axis, ``None`` elsewhere;
    empty for a replicated leaf (JAX's ``PartitionSpec``)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"PartitionSpec{self.parts}"

    @property
    def dim(self):
        """The split axis, or ``None`` for a replicated leaf."""
        return next((i for i, p in enumerate(self.parts) if p is not None),
                    None)


class NamedSharding:
    """A leaf's placement: the mesh and its :class:`PartitionSpec`."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: ParticleMesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def is_fully_replicated(self) -> bool:
        return self.spec.dim is None

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _particle_axes(state, n):
    """(leaves, treedef, per-leaf particle axis or None): a leaf carries
    the particle axis where its spec gives one and its extent there is
    ``n``."""
    leaves, td = tree_flatten(state)
    out = []
    for leaf, ax in zip(leaves, flatten_up_to(td, axes_spec(state))):
        ok = (isinstance(leaf, torch.Tensor) and ax is not None
              and leaf.dim() > ax and leaf.shape[ax] == n)
        out.append(ax if ok else None)
    return leaves, td, out


def state_pspecs(state, axis_name: str = PARTICLE_AXIS, n: int | None = None):
    """A :class:`PartitionSpec` per leaf of any state-like tree: the mesh
    axis at the leaf's particle axis (time-major stacked leaves: axis 1),
    empty (replicated) for leaves shared across particles and scalars."""
    if n is None:
        n = state.n_particles
    leaves, td, axes = _particle_axes(state, n)
    return tree_unflatten(td, [
        PartitionSpec() if ax is None
        else PartitionSpec(*([None] * ax + [axis_name])) for ax in axes])


def state_sharding(mesh: ParticleMesh, state,
                   axis_name: str = PARTICLE_AXIS):
    """A :class:`NamedSharding` per leaf: split along the particle axis,
    or replicated."""
    specs = state_pspecs(state, axis_name)
    leaves, td = tree_flatten(specs,
                              is_leaf=lambda x: isinstance(x, PartitionSpec))
    return tree_unflatten(td, [NamedSharding(mesh, s) for s in leaves])


def replicated_sharding(mesh: ParticleMesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_state(state, mesh: ParticleMesh, axis_name: str = PARTICLE_AXIS):
    """This rank's block of a full state (the same on every rank): each
    leaf cut at its particle axis to ``n / mesh.size`` particles, block
    ``mesh.rank`` of them, on the mesh's device; shared leaves and the LML
    replicated. ``parents`` keep their global indices."""
    from ..smc.state import ParticleFilterState
    if not isinstance(mesh, ParticleMesh):
        raise TypeError(f"shard_state needs a ParticleMesh, got "
                        f"{type(mesh).__name__}")
    if getattr(state, "mesh", None) is not None:
        raise ValueError("the state is already sharded")
    n = state.n_particles
    if n % mesh.size:
        raise ValueError(f"n_particles={n} not divisible by the mesh's "
                         f"{mesh.size} ranks")
    b = n // mesh.size
    leaves, td, axes = _particle_axes(state, n)
    out = []
    for leaf, ax in zip(leaves, axes):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(mesh.device)
            if ax is not None:
                leaf = leaf.narrow(ax, mesh.rank * b, b).contiguous()
        out.append(leaf)
    local = tree_unflatten(td, out)
    return ParticleFilterState(local.traces, local.log_weights,
                               local.log_ml_est, local.parents, mesh=mesh)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_gather(x, mesh: ParticleMesh):
    """Every rank's ``x`` concatenated along axis 0, in block order. Like
    every collective here it is issued on a mesh of one rank too, so that
    one card runs the backend's path."""
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, 0)


def broadcast(x, mesh: ParticleMesh):
    """``x`` as the mesh's first rank holds it, on every rank."""
    x = x.contiguous()
    dist.broadcast(x, src=mesh.ranks[0], group=mesh.group)
    COLLECTIVES["broadcast"] += 1
    return x


def all_to_all(x, out_rows: int, in_splits, out_splits, mesh: ParticleMesh):
    """One ``all_to_all_single`` along axis 0: ``in_splits[d]`` rows of
    ``x`` go to rank ``d``, ``out_splits[r]`` rows come from rank ``r``."""
    out = torch.empty((out_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_to_all_single(out, x.contiguous(), list(out_splits),
                           list(in_splits), group=mesh.group)
    COLLECTIVES["all_to_all"] += 1
    return out


def ring(xs, shift: int, mesh: ParticleMesh):
    """Each tensor of ``xs`` sent to the rank ``shift`` places on and
    received from the rank ``shift`` places back: one batched set of
    point-to-point sends and receives (none where the shift is a whole
    turn: the blocks stay)."""
    K = mesh.size
    if shift % K == 0:
        return list(xs)
    dst = mesh.ranks[(mesh.rank + shift) % K]
    src = mesh.ranks[(mesh.rank - shift) % K]
    outs = [torch.empty_like(x) for x in xs]
    ops = []
    for x, o in zip(xs, outs):
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dst,
                              group=mesh.group))
        ops.append(dist.P2POp(dist.irecv, o, src, group=mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    COLLECTIVES["ring"] += 1
    return outs


def logsumexp(x, mesh: ParticleMesh):
    """log Σ exp of ``x`` over every rank's block (one all-gather of each
    block's max and scaled sum). On one rank it is ``torch.logsumexp``,
    operation for operation."""
    m = torch.max(x)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    s = torch.sum(torch.exp(x - m))
    g = all_gather(torch.stack([m, s])[None], mesh)
    M = torch.max(g[:, 0])
    S = torch.sum(g[:, 1] * torch.exp(g[:, 0] - M))
    return torch.log(S) + M
