from . import distributions as _distributions
from .choicemap import (Address, ChoiceMap, Entry, Selection, EMPTY, ALL,
                        NONE, select, choicemap, normalize_address)
from .distributions import *  # noqa: F401,F403
from .gfi import (Trace, GenFn, DynamicGenFn, gen, trace, NoChange,
                  UnknownChange, Extend, batched_interpretation,
                  current_batch, simulate, generate, propose, assess, update,
                  regenerate, get_choices, get_args, get_retval, get_score,
                  get_gen_fn)
from .combinators import Unfold, MapCombinator

__all__ = (["Address", "ChoiceMap", "Entry", "Selection", "EMPTY", "ALL",
            "NONE", "select", "choicemap", "normalize_address"]
           + _distributions.__all__
           + ["Trace", "GenFn", "DynamicGenFn", "gen", "trace", "NoChange",
              "UnknownChange", "Extend", "batched_interpretation",
              "current_batch", "simulate", "generate", "propose", "assess",
              "update", "regenerate", "get_choices", "get_args",
              "get_retval", "get_score", "get_gen_fn", "Unfold",
              "MapCombinator"])
