from .object_motion import (make_object_motion, init_state, synthesize_data,
                            obs_dense, object_motion_filter,
                            exact_posterior)

__all__ = ["make_object_motion", "init_state", "synthesize_data",
           "obs_dense", "object_motion_filter", "exact_posterior"]
