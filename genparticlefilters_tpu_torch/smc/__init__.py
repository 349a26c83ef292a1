from .state import (ParticleFilterState, pf_state, effective_sample_size,
                    log_ml_estimate, get_norm_weights,
                    batched_choice)
from .resample import pf_resample, pf_systematic_resample, systematic_F
from .initialize import pf_initialize
from .update import pf_update
from .rejuvenate import mh, pf_rejuvenate, pf_move_accept
from .statistics import mean

__all__ = ["ParticleFilterState", "pf_state", "effective_sample_size",
           "log_ml_estimate", "get_norm_weights",
           "batched_choice", "pf_resample", "pf_systematic_resample",
           "systematic_F", "pf_initialize", "pf_update", "mh",
           "pf_rejuvenate", "pf_move_accept", "mean"]
