"""Trace translators: SMC across models and SMCP³.

- :class:`ExtendingTraceTranslator`: extend a trace with choices from a
  forward proposal (or the model's default proposal), optionally passed
  through a deterministic transform.
- :class:`UpdatingTraceTranslator`: forward and backward proposals;
  without a transform this is Del Moral SMC, with one it is SMCP³.
  Weight = Δscore + log|det J| − fwd_score + bwd_score.
- :class:`GeneralTraceTranslator`: move particles between two different
  generative functions.

The deterministic transform is an ordinary function on choicemaps; its
Jacobian correction is computed by forward-mode automatic differentiation
(``torch.func.jacfwd``) over the declared continuous addresses. Under a
batched interpretation the transform runs once on ``[N]``-leading values
and the Jacobian is taken as N per-particle blocks by
``torch.func.vmap(jacfwd(...))``.

Translators take a ``torch.Generator`` and draw from it in order. The
round-trip and discard checks raise eagerly and read the device only when
asked to check.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.choicemap import (ChoiceMap, Entry, EMPTY, normalize_address,
                              value_on)
from ..core.gfi import (GenFn, Trace, UnknownChange, batched_interpretation,
                        current_batch, update as gfi_update)

__all__ = ["TraceTransform", "ExtendingTraceTranslator",
           "UpdatingTraceTranslator", "GeneralTraceTranslator",
           "check_round_trip"]


# ---------------------------------------------------------------------------
# Deterministic transforms with an AD Jacobian correction
# ---------------------------------------------------------------------------

def _get_val(cms, spec):
    which, addr = spec
    e = cms[which].entries.get(normalize_address(addr))
    if e is None:
        raise KeyError(f"transform: missing continuous address {spec}")
    return torch.as_tensor(e.value)


def _set_val(cms, spec, val):
    which, addr = spec
    cm = cms[which]
    k = normalize_address(addr)
    old = cm.entries.get(k)
    entries = dict(cm.entries)
    entries[k] = (Entry(val.reshape(torch.as_tensor(old.value).shape),
                        old.mask) if old is not None else Entry(val, True))
    cms[which] = ChoiceMap(entries)


def _tensor_maps(maps: dict) -> dict:
    """The maps with host values (Python, numpy) as tensors on the device
    of the first tensor value among them (the CPU when all are host
    values), so the transform's ``fn`` only ever sees tensors."""
    device = next((e.value.device for cm in maps.values()
                   for e in cm.entries.values()
                   if isinstance(e.value, torch.Tensor)), "cpu")
    return {w: ChoiceMap({k: e if isinstance(e.value, torch.Tensor)
                          else Entry(value_on(e.value, device), e.mask)
                          for k, e in cm.entries.items()})
            for w, cm in maps.items()}


def _flatten_maps(maps: dict, b: int):
    """Split a dict of choicemaps into the per-particle tensors (leading
    dim ``b``: values and masks) and a function that rebuilds the maps
    from replacements for them; every other leaf stays as it is."""
    slots, leaves = [], []
    for which, cm in maps.items():
        for k, e in cm.entries.items():
            for field in ("value", "mask"):
                x = getattr(e, field)
                if (isinstance(x, torch.Tensor) and x.dim() >= 1
                        and x.shape[0] == b):
                    slots.append((which, k, field))
                    leaves.append(x)

    def rebuild(new_leaves):
        out = {w: dict(cm.entries) for w, cm in maps.items()}
        for (which, k, field), x in zip(slots, new_leaves):
            e = out[which][k]
            out[which][k] = (Entry(x, e.mask) if field == "value"
                             else Entry(e.value, x))
        return {w: ChoiceMap(d) for w, d in out.items()}
    return leaves, rebuild


class TraceTransform:
    """A deterministic map between choicemaps, bijective over its declared
    continuous part, with log|det J| from automatic differentiation.

    For an :class:`ExtendingTraceTranslator`: ``fn(fwd_choices) ->
    model_constraints``; continuous specs are ``("fwd", addr)`` inputs and
    ``("model", addr)`` outputs.

    For an :class:`UpdatingTraceTranslator` (SMCP³) and a
    :class:`GeneralTraceTranslator`: ``fn(prev_model_choices, fwd_choices)
    -> (model_constraints, bwd_choices)``; inputs are ``("prev", addr)`` or
    ``("fwd", addr)``, outputs ``("model", addr)`` or ``("bwd", addr)``.

    ``inverse_fn`` (same signature, roles swapped) enables ``inverse()``
    and the round-trip check."""

    def __init__(self, fn: Callable, continuous_in: Sequence = (),
                 continuous_out: Sequence = (), inverse_fn: Callable = None,
                 inverse_continuous_in: Sequence = None,
                 inverse_continuous_out: Sequence = None):
        self.fn = fn
        self.continuous_in = tuple(continuous_in)
        self.continuous_out = tuple(continuous_out)
        self.inverse_fn = inverse_fn
        self.inverse_continuous_in = tuple(
            inverse_continuous_in if inverse_continuous_in is not None
            else continuous_out)
        self.inverse_continuous_out = tuple(
            inverse_continuous_out if inverse_continuous_out is not None
            else continuous_in)

    def inverse(self) -> "TraceTransform":
        if self.inverse_fn is None:
            raise ValueError("transform has no inverse_fn; provide one to "
                             "use inverse()/round-trip checks")
        return TraceTransform(self.inverse_fn,
                              continuous_in=self.inverse_continuous_in,
                              continuous_out=self.inverse_continuous_out,
                              inverse_fn=self.fn,
                              inverse_continuous_in=self.continuous_out,
                              inverse_continuous_out=self.continuous_in)

    # -- application ------------------------------------------------------
    def _jacobian(self, input_maps: dict, run):
        """The Jacobian of the declared continuous outputs with respect to
        the declared continuous inputs, for one (per-particle) set of
        input maps."""
        in_vals = [_get_val(input_maps, s) for s in self.continuous_in]
        sizes = [v.numel() for v in in_vals]
        shapes = [v.shape for v in in_vals]
        total_in = sum(sizes)

        def g(x_flat):
            maps = dict(input_maps)
            off = 0
            for s, sz, shp in zip(self.continuous_in, sizes, shapes):
                _set_val(maps, s, x_flat[off:off + sz].reshape(shp))
                off += sz
            named = self._name_outputs(run(maps))
            pieces = [_get_val(named, s).reshape(-1).to(torch.float32)
                      for s in self.continuous_out]
            return torch.cat(pieces) if pieces else x_flat[:0]

        x0 = torch.cat([v.reshape(-1).to(torch.float32) for v in in_vals])
        J = torch.func.jacfwd(g)(x0)
        if tuple(J.shape) != (total_in, total_in):
            raise ValueError(
                f"transform Jacobian is {tuple(J.shape)}, not square "
                f"({total_in}); continuous_in/continuous_out must cover the "
                "same total dimension")
        return J

    def _apply(self, input_maps: dict, n_outputs: int):
        """Run ``fn`` and compute log|det J| over the declared continuous
        part.

        Under a batched interpretation of N particles, ``fn`` runs ONCE on
        ``[N]``-leading values (it must be batch-polymorphic, like any
        ``batch_safe`` model body) and the Jacobian is computed as N
        per-particle blocks by a vmapped ``jacfwd``, with the batch stack
        suspended inside: the [N·d, N·d] joint Jacobian is block-diagonal
        (particles are independent), so the per-particle log-determinants
        are exact."""
        def run(maps):
            order = ("prev", "fwd") if "prev" in maps else ("fwd",)
            out = self.fn(*[maps[k] for k in order])
            return (out,) if n_outputs == 1 else out

        input_maps = _tensor_maps(input_maps)
        outs = run(input_maps)
        if not self.continuous_in:
            return outs, 0.0
        b = current_batch()
        if b is None:
            J = self._jacobian(input_maps, run)
        else:
            leaves, rebuild = _flatten_maps(input_maps, b)
            with batched_interpretation(None):
                J = torch.func.vmap(
                    lambda *pp: self._jacobian(rebuild(pp), run))(*leaves)
        return outs, torch.linalg.slogdet(J).logabsdet

    def _name_outputs(self, outs):
        if len(outs) == 1:
            return {"model": outs[0]}
        return {"model": outs[0], "bwd": outs[1]}

    def apply_extending(self, fwd_choices: ChoiceMap):
        outs, logdet = self._apply({"fwd": fwd_choices}, 1)
        return outs[0], logdet

    def apply_updating(self, prev_choices: ChoiceMap, fwd_choices: ChoiceMap):
        outs, logdet = self._apply(
            {"prev": prev_choices, "fwd": fwd_choices}, 2)
        return outs[0], outs[1], logdet


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _choices_close(a: ChoiceMap, b: ChoiceMap, atol=1e-4):
    """Every present entry of ``a`` matches ``b`` within ``atol``: a device
    bool, or the Python ``False`` for a structural mismatch (a missing
    address or another shape)."""
    oks = []
    for k, e in a.entries.items():
        e2 = b.entries.get(k)
        if e2 is None:
            return False
        va, vb = torch.as_tensor(e.value), torch.as_tensor(e2.value)
        if va.shape != vb.shape:
            return False
        ok = (va.to(torch.float32) - vb.to(torch.float32)).abs() <= atol
        if e.mask is not True:
            ok = ok | ~e.mask_array()
        oks.append(ok.all())
    return torch.stack(oks).all() if oks else True


def check_round_trip(prev_trace: Trace, prev_trace_rt: Trace,
                     fwd_trace: Trace = None, fwd_trace_rt: Trace = None):
    """Bijection check: the inverse translator must rebuild the input
    traces within tolerance; raises ``ValueError`` otherwise (a read of the
    device)."""
    if not bool(_choices_close(prev_trace.get_choices(),
                               prev_trace_rt.get_choices())):
        raise ValueError("round-trip check failed: model trace mismatch")
    if fwd_trace is not None and fwd_trace_rt is not None and not bool(
            _choices_close(fwd_trace.get_choices(),
                           fwd_trace_rt.get_choices())):
        raise ValueError("round-trip check failed: proposal trace mismatch")


def _check_no_discard(discard: ChoiceMap, check: bool):
    """An update that discarded choices is not an extension: raise when
    checking and any discard entry is present. Nothing is read from the
    device unless ``check`` is set."""
    if not check or discard.is_empty():
        return
    if bool(discard.total_mask_any()):
        raise ValueError(
            "Choices were updated or deleted during pf_update; pass "
            "check=False to allow replacing previous observations.")


# ---------------------------------------------------------------------------
# Translators
# ---------------------------------------------------------------------------

def _unknown(args):
    return tuple(UnknownChange() for _ in args)


class ExtendingTraceTranslator:
    def __init__(self, p_new_args=(), p_argdiffs=None,
                 new_observations: ChoiceMap = EMPTY,
                 q_forward: GenFn | None = None, q_forward_args=(),
                 transform: TraceTransform | None = None):
        self.p_new_args = tuple(p_new_args)
        self.p_argdiffs = (tuple(p_argdiffs) if p_argdiffs is not None
                           else _unknown(self.p_new_args))
        self.new_observations = new_observations
        self.q_forward = q_forward
        self.q_forward_args = tuple(q_forward_args)
        self.transform = transform

    def __call__(self, gen, prev_trace: Trace, check: bool = True):
        """``(new_trace, incremental log weight)``."""
        if self.q_forward is None:
            new_tr, w, _, discard = gfi_update(
                gen, prev_trace, self.p_new_args, self.p_argdiffs,
                self.new_observations)
            _check_no_discard(discard, check)
            return new_tr, w
        fwd_choices, fwd_score, _ = self.q_forward.propose(
            gen, (prev_trace,) + self.q_forward_args)
        constraints, logdet = fwd_choices, 0.0
        if self.transform is not None:
            constraints, logdet = self.transform.apply_extending(fwd_choices)
        new_tr, score_diff, _, discard = gfi_update(
            gen, prev_trace, self.p_new_args, self.p_argdiffs,
            constraints.merge(self.new_observations))
        _check_no_discard(discard, check)
        return new_tr, score_diff - fwd_score + logdet


class UpdatingTraceTranslator:
    def __init__(self, p_new_args=(), p_argdiffs=None,
                 new_observations: ChoiceMap = EMPTY,
                 q_forward: GenFn = None, q_forward_args=(),
                 q_backward: GenFn = None, q_backward_args=(),
                 transform: TraceTransform | None = None,
                 p_prev_args=None):
        self.p_new_args = tuple(p_new_args)
        self.p_argdiffs = (tuple(p_argdiffs) if p_argdiffs is not None
                           else _unknown(self.p_new_args))
        self.new_observations = new_observations
        self.q_forward = q_forward
        self.q_forward_args = tuple(q_forward_args)
        self.q_backward = q_backward
        self.q_backward_args = tuple(q_backward_args)
        self.transform = transform
        #: the model args the PREVIOUS trace was produced under, for
        #: :meth:`inverse`; None reads them from the trace
        self.p_prev_args = None if p_prev_args is None else tuple(p_prev_args)

    def inverse(self, prev_trace: Trace,
                prev_observations: ChoiceMap = EMPTY):
        """Swap forward and backward and invert the transform."""
        prev_args = (self.p_prev_args if self.p_prev_args is not None
                     else prev_trace.get_args())
        return UpdatingTraceTranslator(
            p_new_args=prev_args, p_argdiffs=_unknown(prev_args),
            new_observations=prev_observations,
            q_forward=self.q_backward, q_forward_args=self.q_backward_args,
            q_backward=self.q_forward, q_backward_args=self.q_forward_args,
            transform=(self.transform.inverse()
                       if self.transform is not None else None))

    def run_transform(self, gen, prev_trace: Trace, fwd_trace: Trace):
        """``(new_model_trace, bwd_trace, log|det J|, model score diff)``."""
        if self.transform is None:
            new_tr, score_diff, _, bwd_constraints = gfi_update(
                gen, prev_trace, self.p_new_args, self.p_argdiffs,
                fwd_trace.get_choices().merge(self.new_observations))
            logdet = 0.0
        else:
            constraints, bwd_constraints, logdet = (
                self.transform.apply_updating(prev_trace.get_choices(),
                                              fwd_trace.get_choices()))
            new_tr, score_diff, _, _ = gfi_update(
                gen, prev_trace, self.p_new_args, self.p_argdiffs,
                constraints.merge(self.new_observations))
        bwd_tr, _ = self.q_backward.generate(
            gen, (new_tr,) + self.q_backward_args, bwd_constraints)
        return new_tr, bwd_tr, logdet, score_diff

    def __call__(self, gen, prev_trace: Trace, check: bool = False,
                 prev_observations: ChoiceMap = EMPTY):
        """``(new_trace, incremental log weight)``; with ``check``, the
        inverse translator must rebuild ``prev_trace`` and the forward
        trace."""
        fwd_trace = self.q_forward.simulate(
            gen, (prev_trace,) + self.q_forward_args)
        new_tr, bwd_tr, logdet, score_diff = self.run_transform(
            gen, prev_trace, fwd_trace)
        weight = (score_diff + logdet - fwd_trace.get_score()
                  + bwd_tr.get_score())
        if check:
            inverter = self.inverse(prev_trace, prev_observations)
            prev_rt, fwd_rt, _, _ = inverter.run_transform(gen, new_tr,
                                                           bwd_tr)
            check_round_trip(prev_trace, prev_rt, fwd_trace, fwd_rt)
        return new_tr, weight


class GeneralTraceTranslator:
    """Move particles between two different generative functions.

    ``transform(old_choices, fwd_choices) -> (new_model_constraints,
    bwd_choices)`` must constrain EVERY choice of ``new_model`` (the new
    trace is generated fully constrained). Weight = score_new − score_old
    + log|det J| − fwd_score + bwd_score."""

    def __init__(self, new_model: GenFn, new_args=(),
                 q_forward: GenFn = None, q_forward_args=(),
                 q_backward: GenFn = None, q_backward_args=(),
                 transform: TraceTransform = None):
        self.new_model = new_model
        self.new_args = tuple(new_args)
        self.q_forward = q_forward
        self.q_forward_args = tuple(q_forward_args)
        self.q_backward = q_backward
        self.q_backward_args = tuple(q_backward_args)
        self.transform = transform

    def __call__(self, gen, prev_trace: Trace, check: bool = False):
        fwd_score, fwd_choices = 0.0, EMPTY
        if self.q_forward is not None:
            fwd_choices, fwd_score, _ = self.q_forward.propose(
                gen, (prev_trace,) + self.q_forward_args)
        constraints, bwd_constraints, logdet = (
            self.transform.apply_updating(prev_trace.get_choices(),
                                          fwd_choices))
        new_tr, _ = self.new_model.generate(gen, self.new_args, constraints)
        bwd_score = 0.0
        if self.q_backward is not None:
            bwd_tr, _ = self.q_backward.generate(
                gen, (new_tr,) + self.q_backward_args, bwd_constraints)
            bwd_score = bwd_tr.get_score()
        weight = (new_tr.get_score() - prev_trace.get_score() + logdet
                  - fwd_score + bwd_score)
        return new_tr, weight
