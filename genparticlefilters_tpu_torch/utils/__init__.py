from .weights import (logsumexp, lognorm, softmax, safe_softmax,
                      ess_from_log_weights, apply_check)
