"""Parallel layer: particle meshes over ``torch.distributed``, sharded
particle states, shard-local (blockwise) resampling and block exchange,
on one device or across the ranks of a mesh."""

from . import mesh as _mesh
from . import distributed as _distributed

from .mesh import *  # noqa: F401,F403
from .distributed import *  # noqa: F401,F403

__all__ = _mesh.__all__ + _distributed.__all__
