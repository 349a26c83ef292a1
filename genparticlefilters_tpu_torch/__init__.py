"""genparticlefilters_tpu_torch — the PyTorch + CUDA port of
genparticlefilters_tpu (Sequential Monte Carlo for Gen-style models).

The JAX package beside it is the reference each part is held against.
This package imports ``torch`` and never ``jax``. Ported so far: the
object-motion filter's main path (batched interpretation, packed Unfold
storage, systematic resampling through the G1 CUDA gather, windowed MH
rejuvenation, Extend updates).
"""

from .core import *  # noqa: F401,F403
from .smc import *  # noqa: F401,F403
from .ops import resample_gather_split, resample_gather_split_plain  # noqa
from .utils.weights import logsumexp, safe_softmax  # noqa: F401
