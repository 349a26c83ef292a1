from . import object_motion as _object_motion
from . import linear_gaussian as _linear_gaussian

from .object_motion import *  # noqa: F401,F403
from .linear_gaussian import *  # noqa: F401,F403

__all__ = _object_motion.__all__ + _linear_gaussian.__all__
