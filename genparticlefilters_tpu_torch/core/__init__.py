from .choicemap import (ChoiceMap, Entry, Selection, EMPTY, ALL, select,
                        normalize_address)
from .distributions import (Distribution, Normal, Bernoulli, UniformDiscrete,
                            normal, bernoulli, uniform_discrete)
from .gfi import (Trace, GenFn, DynamicGenFn, gen, trace, NoChange,
                  UnknownChange, Extend, batched_interpretation,
                  current_batch, simulate, generate, update, regenerate)
from .combinators import Unfold

__all__ = ["ChoiceMap", "Entry", "Selection", "EMPTY", "ALL", "select",
           "normalize_address", "Distribution",
           "Normal", "Bernoulli", "UniformDiscrete", "normal", "bernoulli",
           "uniform_discrete", "Trace", "GenFn",
           "DynamicGenFn", "gen", "trace", "NoChange", "UnknownChange",
           "Extend", "batched_interpretation", "current_batch", "simulate",
           "generate", "update", "regenerate", "Unfold"]
