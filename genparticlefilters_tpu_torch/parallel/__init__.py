"""Parallel layer: blockwise (shard-local) resampling and block exchange.
Only the one-device form is ported; the sharded form over
``torch.distributed`` waits for more than one card."""

from . import distributed as _distributed

from .distributed import *  # noqa: F401,F403

__all__ = _distributed.__all__
