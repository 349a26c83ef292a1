from . import object_motion as _object_motion
from . import linear_gaussian as _linear_gaussian
from . import multi_object as _multi_object
from . import stochastic_volatility as _stochastic_volatility
from . import tempered as _tempered

from .object_motion import *  # noqa: F401,F403
from .linear_gaussian import *  # noqa: F401,F403
from .multi_object import *  # noqa: F401,F403
from .stochastic_volatility import *  # noqa: F401,F403
from .tempered import *  # noqa: F401,F403

__all__ = (_object_motion.__all__ + _linear_gaussian.__all__
           + _multi_object.__all__ + _stochastic_volatility.__all__
           + _tempered.__all__)
