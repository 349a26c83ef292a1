"""genparticlefilters_tpu_torch — the PyTorch + CUDA port of
genparticlefilters_tpu (Sequential Monte Carlo for Gen-style models).

The JAX package beside it is the reference each part is held against.
This package imports ``torch`` and never ``jax``. Ported so far: the
object-motion, linear-Gaussian, stochastic-volatility (config 3, with
move-reweight rejuvenation) and multi-object tracking (config 5, with its
data-association variant) filters and tempered SMC (config 4, by
args-update or SMCP³ translator), on the batched interpretation (packed
Unfold storage, windowed rejuvenation, Extend updates); the GFI verbs
with ``propose``/``assess`` and all 19 distributions of the JAX package;
the per-particle interpretation (``vmap_gfi`` on ``torch.func.vmap``), which
every model, proposal or translator not marked ``batch_safe`` runs, and
the batched-layout guard (``config``); checkpointing and profiling
(``utils``); custom and
stratified ``pf_initialize``/``pf_update``, the trace translators
(extending, updating, general, with AD Jacobians) and ``mh`` and
``move_reweight`` in every form, on states and sub-state views;
multinomial, residual, stratified and systematic resampling; resizing
(multinomial, residual and optimal resize, replicate, dereplicate,
coalesce, introduce); one-device blockwise resampling and block rotation
and shuffling (``parallel``); and the CUDA kernels G1 and G2 (fused
resampling gathers), G3 (explicit-parents gather) and G4 (merge count).
"""

from . import config  # noqa: F401
from .core import *  # noqa: F401,F403
from .smc import *  # noqa: F401,F403
from .parallel import *  # noqa: F401,F403
from .ops import (resample_gather_split, resample_gather_split_plain,  # noqa
                  resample_gather_split_u, resample_gather_split_u_plain,
                  merge_count, merge_count_plain, gather_cols,
                  gather_cols_plain, gather_rows, gather_rows_plain)
from .utils.weights import logsumexp, safe_softmax  # noqa: F401
from .utils.stratification import choiceproduct  # noqa: F401
