from .weights import (logsumexp, lognorm, softmax, safe_softmax,
                      ess_from_log_weights, apply_check)
from .stratification import (choiceproduct, stratum_assignment, stack_strata,
                             gather_strata)
