from . import state as _state
from . import initialize as _initialize
from . import update as _update
from . import resample as _resample
from . import rejuvenate as _rejuvenate
from . import statistics as _statistics
from . import algorithms as _algorithms
from . import resize as _resize
from . import translate as _translate

from .state import *  # noqa: F401,F403
from .initialize import *  # noqa: F401,F403
from .update import *  # noqa: F401,F403
from .resample import *  # noqa: F401,F403
from .rejuvenate import *  # noqa: F401,F403
from .statistics import *  # noqa: F401,F403
from .algorithms import *  # noqa: F401,F403
from .resize import *  # noqa: F401,F403
from .translate import *  # noqa: F401,F403
from ..utils.weights import lognorm, softmax, safe_softmax  # noqa: F401
from ..utils.stratification import choiceproduct  # noqa: F401

__all__ = (
    _state.__all__ + _initialize.__all__ + _update.__all__
    + _resample.__all__ + _rejuvenate.__all__ + _statistics.__all__
    + _algorithms.__all__ + _resize.__all__ + _translate.__all__
    + ["lognorm", "softmax", "safe_softmax", "choiceproduct"]
)
