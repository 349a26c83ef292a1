"""Global toggles.

The JAX package's ``clustered_gather`` switch (its Pallas clustered
gather against the XLA path) has no counterpart: the port's resampling
always takes its CUDA kernels on the card and their plain versions on
the CPU.
"""

from __future__ import annotations

import contextlib

__all__ = ["check_batched_layout", "use_check_batched_layout"]

#: Guard against the batched-interpretation shape ambiguity: a genuinely
#: shared array whose leading dim equals the particle count N is
#: indistinguishable from a per-particle value inside a batched
#: interpretation (core/gfi.py batchedness convention). When enabled, the
#: batched pf_initialize/pf_update paths compare the batched trace layout
#: against a per-particle interpretation evaluated on fake tensors (no
#: kernel, no host read) and raise if any leaf's shape is inconsistent.
#: A pass is cached by the call's shapes (core/batching.py layout_key), so
#: a filter pays for it once per distinct step.
check_batched_layout: bool = True


@contextlib.contextmanager
def use_check_batched_layout(enabled: bool = True):
    global check_batched_layout
    prev = check_batched_layout
    check_batched_layout = enabled
    try:
        yield
    finally:
        check_batched_layout = prev
