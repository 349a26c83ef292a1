"""Rejuvenation moves.

- ``pf_rejuvenate`` dispatches to ``move`` (MCMC accept/reject, weights
  untouched) or ``reweight`` (the kernel returns a relative log weight
  that is added to the particle weights).
- ``mh``: Metropolis–Hastings in its three forms: selection (regenerate
  through the trace's delta protocol), custom proposal, involution.
- ``move_reweight``: the four variants (selection, proposal, proposal with
  an involution, distinct forward and backward proposals with an
  involution).

Kernels are ``(gen, trace, ...) -> (trace, aux)`` functions; the
accept/reject branch is a per-particle select, and ``n_iters`` sweeps run
under ONE batched interpretation for a ``batch_safe`` model, else per
particle (one ``vmap_gfi`` map over all sweeps). With
``return_stats=True`` the kernels' aux comes back as tensors: the accept
flags or relative weights ``[N, n_iters]``. Both verbs work on full
states and on sub-state views; ``check``/``observations`` are honored
once, at state level, after the sweeps.
"""

from __future__ import annotations

import torch

from ..core.batching import check_later, vmap_gfi
from ..core.choicemap import ChoiceMap, Selection, EMPTY, value_on
from ..core.gfi import GenFn, NoChange, Trace, batched_interpretation
from .update import _block

__all__ = ["mh", "move_reweight", "check_observations", "pf_move_accept",
           "pf_move_reweight", "pf_rejuvenate"]


def _nochange(args):
    return tuple(NoChange() for _ in args)


def check_observations(choices: ChoiceMap, observations: ChoiceMap,
                       atol=1e-5):
    """Raise ``ValueError`` unless every observed choice is preserved
    where it is present (a read of the device, deferred to the end of a
    ``vmap_gfi`` map). A stored value with more axes than the observation
    (a particle axis) is compared against the observation broadcast over
    them."""
    for k, e in observations.entries.items():
        stored = choices.resolve(k)
        if stored is None:
            raise ValueError(f"observation at {k} missing from trace")
        got = torch.as_tensor(stored.value).to(torch.float32)
        want = value_on(e.value, got.device).to(torch.float32)
        extra = got.dim() - want.dim()
        if extra > 0 and tuple(got.shape[extra:]) != tuple(want.shape):
            want = want.reshape(tuple(want.shape) + (1,) * extra)
        bad = (got - want).abs() > atol
        if stored.mask is not True:
            bad = bad & stored.mask_array()

        def modified(k=k):
            raise ValueError(f"observation at {k} was modified")
        check_later(torch.any(bad), modified)


def _uniform_accept(gen, w):
    u = torch.rand(w.shape, generator=gen, dtype=torch.float32,
                   device=w.device)
    return torch.log(u) < w


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def mh(gen, trace: Trace, selection_or_proposal, proposal_args=None,
       involution=None, check=False, observations: ChoiceMap = EMPTY,
       window: int | None = None):
    """Metropolis–Hastings kernel: ``(new_trace, accept)``.

    Selection form: regenerate the selected addresses from the internal
    proposal and accept with probability ``min(1, e^weight)``; the
    proposed trace is never materialized, ``regenerate_delta`` returns what
    ``apply_regenerate_delta`` writes under the accept mask. Proposal form:
    propose from a custom proposal, update, and assess the discarded
    choices under the proposal for the reverse density. Involution form:
    ``involution(trace, fwd_choices, fwd_ret, p_args) -> (new_trace,
    bwd_choices, weight)``."""
    args = trace.get_args()
    if isinstance(selection_or_proposal, Selection):
        delta, w = trace.gen_fn.regenerate_delta(
            gen, trace, args, _nochange(args), selection_or_proposal,
            window=window)
        accept = _uniform_accept(gen, w)
        out = trace.gen_fn.apply_regenerate_delta(trace, delta, accept)
    else:
        proposal: GenFn = selection_or_proposal
        p_args = tuple(proposal_args or ())
        if involution is not None:
            fwd_choices, fwd_score, fwd_ret = proposal.propose(
                gen, (trace,) + p_args)
            new_tr, bwd_choices, w_inv = involution(trace, fwd_choices,
                                                    fwd_ret, p_args)
            _, bwd_score = proposal.assess((new_tr,) + p_args, bwd_choices)
            w = w_inv - fwd_score + bwd_score
        else:
            fwd_choices, fwd_score, _ = proposal.propose(
                gen, (trace,) + p_args)
            new_tr, w_upd, _, discard = trace.gen_fn.update(
                gen, trace, args, _nochange(args), fwd_choices)
            _, bwd_score = proposal.assess((new_tr,) + p_args, discard)
            w = w_upd - fwd_score + bwd_score
        accept = _uniform_accept(gen, w)
        out = trace.gen_fn.select_trace(accept, new_tr, trace)
    if check:
        check_observations(out.get_choices(), observations)
    return out, accept


def move_reweight(gen, trace: Trace, selection_or_proposal,
                  proposal_args=None, involution=None,
                  bwd_proposal: GenFn | None = None, bwd_args=None,
                  check=False, observations: ChoiceMap = EMPTY,
                  window: int | None = None):
    """Move-reweight kernel (Marques & Storvik 2013): ``(new_trace,
    rel_log_weight)``. The move is always taken.

    1. selection: regenerate (through ``window`` on an Unfold),
       rel_weight = the regenerate weight;
    2. proposal: propose → update → assess(discard), w = Δ − fwd + bwd;
    3. proposal + involution;
    4. distinct forward and backward proposals + involution."""
    args = trace.get_args()
    if isinstance(selection_or_proposal, Selection):
        new_tr, rel_w = trace.gen_fn.regenerate(
            gen, trace, args, _nochange(args), selection_or_proposal,
            window=window)
        if check:
            check_observations(new_tr.get_choices(), observations)
        return new_tr, rel_w
    proposal: GenFn = selection_or_proposal
    p_args = tuple(proposal_args or ())
    fwd_choices, fwd_score, fwd_ret = proposal.propose(gen,
                                                       (trace,) + p_args)
    if involution is None:
        new_tr, w, _, discard = trace.gen_fn.update(
            gen, trace, args, _nochange(args), fwd_choices)
        _, bwd_score = proposal.assess((new_tr,) + p_args, discard)
    else:
        new_tr, bwd_choices, w = involution(trace, fwd_choices, fwd_ret,
                                            p_args)
        scorer = bwd_proposal if bwd_proposal is not None else proposal
        s_args = tuple(bwd_args or ()) if bwd_proposal is not None else p_args
        _, bwd_score = scorer.assess((new_tr,) + s_args, bwd_choices)
    if check:
        check_observations(new_tr.get_choices(), observations)
    return new_tr, w - fwd_score + bwd_score


# ---------------------------------------------------------------------------
# State-level rejuvenation
# ---------------------------------------------------------------------------

def _sweeps(gen, traces, kern, kern_args, n_iters, kwargs):
    """Apply ``kern`` ``n_iters`` times to every particle: under ONE
    batched interpretation for a ``batch_safe`` model, else per particle in
    one ``vmap_gfi`` map. Returns ``(traces, aux sum [N], aux [N,
    n_iters])``, the aux as float32."""
    n = int(traces.score.shape[0])
    batched = getattr(traces.gen_fn, "batch_safe", False)

    def run(tr):
        auxs = []
        for _ in range(n_iters):
            tr, aux = kern(gen, tr, *kern_args, **kwargs)
            aux = torch.as_tensor(aux).to(torch.float32)
            auxs.append(aux.expand(n) if batched else aux)
        aux_sum = auxs[0]
        for a in auxs[1:]:
            aux_sum = aux_sum + a
        return tr, aux_sum, torch.stack(auxs, dim=-1)

    if not batched:
        return vmap_gfi(run, traces)
    with batched_interpretation(n):
        return run(traces)


def _pop_check(kwargs):
    """``check`` and ``observations`` are honored once, at state level,
    after the sweeps: the kernels run without them."""
    return kwargs.pop("check", False), kwargs.pop("observations", EMPTY)


def _verify_observations(check, observations, traces):
    if check and not observations.is_empty():
        check_observations(traces.get_choices(), observations)


def pf_move_accept(gen, state, kern=mh, kern_args=(), n_iters: int = 1,
                   return_stats: bool = False, **kwargs):
    """MCMC rejuvenation; weights untouched. With ``return_stats``, also
    ``{"accepts": [N, n_iters], "accept_rate": mean}``."""
    traces, log_weights, _, scatter = _block(state)
    check, observations = _pop_check(kwargs)
    new_traces, acc_sum, acc_all = _sweeps(gen, traces, kern, kern_args,
                                           n_iters, kwargs)
    _verify_observations(check, observations, new_traces)
    out = scatter(new_traces, log_weights)
    if return_stats:
        return out, {"accepts": acc_all,
                     "accept_rate": torch.mean(acc_sum / float(n_iters))}
    return out


def pf_move_reweight(gen, state, kern=move_reweight, kern_args=(),
                     n_iters: int = 1, return_stats: bool = False, **kwargs):
    """Move-reweight rejuvenation: the kernels' relative weights add to
    the particle weights. With ``return_stats``, also ``{"rel_weights":
    [N, n_iters]}``."""
    traces, log_weights, _, scatter = _block(state)
    check, observations = _pop_check(kwargs)
    new_traces, w_sum, w_all = _sweeps(gen, traces, kern, kern_args, n_iters,
                                       kwargs)
    _verify_observations(check, observations, new_traces)
    out = scatter(new_traces, log_weights + w_sum)
    if return_stats:
        return out, {"rel_weights": w_all}
    return out


def pf_rejuvenate(gen, state, kern=mh, kern_args=(), n_iters: int = 1,
                  method: str = "move", **kwargs):
    """Dispatcher: ``method="move"`` or ``"reweight"``."""
    if method == "move":
        return pf_move_accept(gen, state, kern, kern_args, n_iters, **kwargs)
    if method == "reweight":
        return pf_move_reweight(gen, state, kern, kern_args, n_iters,
                                **kwargs)
    raise ValueError(f"Method {method!r} not recognized.")
