from .choicemap import (ChoiceMap, Entry, Selection, EMPTY, ALL, select,
                        choicemap, normalize_address)
from .distributions import (Distribution, Normal, Bernoulli, UniformDiscrete,
                            Factor, normal, bernoulli, uniform_discrete,
                            factor)
from .gfi import (Trace, GenFn, DynamicGenFn, gen, trace, NoChange,
                  UnknownChange, Extend, batched_interpretation,
                  current_batch, simulate, generate, propose, assess, update,
                  regenerate, get_choices, get_args, get_retval, get_score,
                  get_gen_fn)
from .combinators import Unfold, MapCombinator

__all__ = ["ChoiceMap", "Entry", "Selection", "EMPTY", "ALL",
           "select", "choicemap", "normalize_address", "Distribution",
           "Normal", "Bernoulli", "UniformDiscrete", "Factor", "normal",
           "bernoulli", "uniform_discrete", "factor", "Trace", "GenFn",
           "DynamicGenFn", "gen", "trace", "NoChange", "UnknownChange",
           "Extend", "batched_interpretation", "current_batch", "simulate",
           "generate", "propose", "assess", "update", "regenerate",
           "get_choices", "get_args", "get_retval", "get_score",
           "get_gen_fn", "Unfold", "MapCombinator"]
