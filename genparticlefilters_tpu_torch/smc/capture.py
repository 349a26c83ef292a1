"""The JAX package's compiled drivers on the card: ``jax.jit`` +
``lax.scan`` + ``lax.cond`` become one captured CUDA graph per filter run.

- :func:`device_cond` is ``lax.cond(pred, branch, lambda s: s, state)``.
  Eager (a CPU predicate, or the card while nothing is being captured) it
  reads ``pred`` on the host and runs ``branch`` or not. While a CUDA graph
  is being captured it is a device select, JAX's own ``lax.cond`` under
  ``vmap``: the branch always runs, and each leaf it replaced becomes
  ``torch.where(pred, out, in)``, a fresh tensor, so no incoming tensor is
  written. (PyTorch 2.11 has no CUDA conditional nodes:
  ``CUDAGraph.begin_capture_to_if_node`` is missing.)
  Either way, a branch that returns another structure, leaf shape or
  dtype than it was given raises ``TypeError``, as ``lax.cond`` does.
- :func:`host_pred` is where a filter loop reads its predicate: on the
  host (inside the loop's ``ess_check`` span) unless the captured form
  runs.
- :func:`capture` is ``jax.jit`` for one static configuration: it builds
  every kernel, runs ``fn`` once eagerly in its captured form (every
  kernel, library and lazy initialisation meets the card before the
  capture), captures one run into a private memory pool with the
  generator registered, and returns a :class:`CapturedRun`. The filters'
  Python loops unroll under the capture, as ``lax.scan`` is lowered.

The captured branch draws its random numbers at every step, taken or
not: a replay draws the eager run's numbers where every branch fires. The
kernels' ``launches`` counters and ``Unfold.steps_run`` count at capture,
not per replay.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

from ..core.batching import BOUNDARY
from ..core.gfi import GenFn
from ..core.tree import tree_flatten, tree_unflatten

__all__ = ["device_cond", "host_pred", "capture", "CapturedRun"]

# > 0 while capture() warms up: device_cond runs its captured form eagerly
_WARMING = [0]


def _graph_form(pred) -> bool:
    """Whether ``device_cond`` takes its captured form for ``pred``: a
    graph is being captured on the card, or :func:`capture` warms up."""
    return isinstance(pred, torch.Tensor) and pred.is_cuda and (
        _WARMING[0] > 0 or torch.cuda.is_current_stream_capturing())


def host_pred(pred):
    """``pred`` as a Python bool (one host read), or the device tensor
    itself where :func:`device_cond` takes its captured form."""
    return pred if _graph_form(pred) else bool(pred)


def _same_static(a, b) -> bool:
    if a is b:
        return True
    try:
        return bool(a == b)
    except (RuntimeError, TypeError, ValueError):
        return False


def _flatten_like(state, out):
    """The leaves of ``state`` and ``out`` and ``out``'s structure; raises
    ``TypeError`` where ``out`` differs from ``state`` in structure, in a
    tensor leaf's shape, dtype or device, or in a static leaf."""
    in_leaves, in_def = tree_flatten(state)
    out_leaves, out_def = tree_flatten(out)
    if out_def != in_def:
        raise TypeError(
            f"device_cond: the branch returned another structure than it "
            f"was given ({out_def} against {in_def}); as with lax.cond, "
            f"both sides must return the same tree structure")
    for i, (x, o) in enumerate(zip(in_leaves, out_leaves)):
        if isinstance(x, torch.Tensor) and isinstance(o, torch.Tensor):
            if (x.shape, x.dtype, x.device) != (o.shape, o.dtype, o.device):
                raise TypeError(
                    f"device_cond: leaf {i} enters as {x.dtype} "
                    f"{tuple(x.shape)} on {x.device} and leaves the branch "
                    f"as {o.dtype} {tuple(o.shape)} on {o.device}")
        elif (isinstance(x, torch.Tensor) or isinstance(o, torch.Tensor)
              or not _same_static(x, o)):
            raise TypeError(f"device_cond: static leaf {i} enters as {x!r} "
                            f"and leaves the branch as {o!r}")
    return in_leaves, out_leaves, out_def


def _select(pred, branch, state):
    """The captured form: ``branch(state)`` always, then each leaf it
    replaced selected on the device, ``torch.where(pred, out, in)``."""
    out = branch(state)
    in_leaves, out_leaves, out_def = _flatten_like(state, out)
    pred = pred.reshape(())
    return tree_unflatten(out_def, [
        torch.where(pred, o, x) if isinstance(o, torch.Tensor) and o is not x
        else o for x, o in zip(in_leaves, out_leaves)])


def device_cond(pred, branch: Callable, state):
    """``branch(state)`` where ``pred`` holds, else ``state``; the
    counterpart of ``lax.cond(pred, branch, lambda s: s, state)``.

    ``pred`` is a Python bool or a one-element bool tensor. Eager, it is
    read on the host. While a CUDA graph is being captured it stays on the
    device: the branch always runs and every leaf it replaced is selected,
    ``torch.where(pred, out, in)``. Raises ``TypeError`` where the branch
    changes the structure, a leaf's shape or dtype, or a static leaf."""
    if _graph_form(pred):
        return _select(pred, branch, state)
    if not bool(pred):
        return state
    out = branch(state)
    _flatten_like(state, out)
    return out


@contextlib.contextmanager
def _warming():
    _WARMING[0] += 1
    try:
        yield
    finally:
        _WARMING[0] -= 1


def _map_inputs(x, fn):
    """``fn`` over the tensor and numpy leaves of ``x``, through plain
    tuples, lists and dicts (other objects, named tuples included, pass
    as they are)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    if type(x) in (tuple, list):
        return type(x)(_map_inputs(v, fn) for v in x)
    if type(x) is dict:
        return {k: _map_inputs(v, fn) for k, v in x.items()}
    return x


def _plain_leaves(x):
    """The leaves of ``x`` through plain tuples, lists and dicts."""
    if type(x) in (tuple, list):
        return [v for c in x for v in _plain_leaves(c)]
    if type(x) is dict:
        return [v for c in x.values() for v in _plain_leaves(c)]
    return [x]


def _refuse_uncapturable(fn, args, kw):
    """Raise for the forms that run uncaptured: a particle mesh and a
    generative function that is not ``batch_safe`` (its per-particle
    interpretation)."""
    name = getattr(fn, "__name__", "fn")
    if kw.get("mesh") is not None:
        raise NotImplementedError(
            f"capture({name}, mesh=...): a particle mesh runs uncaptured "
            f"(its collectives and the global resample's host read); call "
            f"{name}(gen, ...) eagerly")
    unmarked = [x for x in _plain_leaves((args, kw))
                if isinstance(x, GenFn) and not getattr(x, "batch_safe",
                                                        False)]
    if unmarked or kw.get("batch_safe", True) is False:
        raise NotImplementedError(
            f"capture({name}): a model that is not batch_safe runs per "
            f"particle (vmap_gfi), which runs uncaptured; call "
            f"{name}(gen, ...) eagerly")


def _fresh(tree):
    """``tree`` with every tensor leaf cloned (one clone per tensor, so
    leaves that share a tensor still share one)."""
    leaves, treedef = tree_flatten(tree)
    clones = {}

    def fresh(x):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) not in clones:
            clones[id(x)] = x.clone()
        return clones[id(x)]
    return tree_unflatten(treedef, [fresh(x) for x in leaves])


class CapturedRun:
    """One filter run captured as a CUDA graph.

    ``run(*args, **kw)`` takes arguments in the places :func:`capture` took
    them after ``gen``, a prefix of the positional ones and any of the
    keywords (those not given keep their captured values): each tensor
    (or numpy array) is copied into its static input buffer, every other
    argument must equal the captured one. ``run()`` replays with the
    buffers as they are. The replay draws from the registered generator at
    its current state and advances it by the whole graph's draws; the
    result's tensors are fresh clones, as ``jit`` returns fresh arrays.

    ``capture_seconds`` is the capture's host time (like a compile time),
    ``pool_bytes`` the device memory the capture's pool reached beyond what
    was allocated before it."""

    def __init__(self, fn, graph, inputs, out, capture_seconds, pool_bytes):
        self.fn = fn
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.capture_seconds = capture_seconds
        self.pool_bytes = pool_bytes

    def _load(self, args, kw):
        s_args, s_kw = self.inputs
        unknown = sorted(set(kw) - set(s_kw))
        if len(args) > len(s_args) or unknown:
            raise ValueError(
                f"{self!r}: captured with {len(s_args)} positional "
                f"arguments and keywords {sorted(s_kw)}, called with "
                f"{len(args)} and {sorted(kw)}")
        for dst, src in (list(zip(s_args, args))
                         + [(s_kw[k], v) for k, v in kw.items()]):
            self._load_one(dst, src)

    def _load_one(self, dst, src):
        """Copy ``src`` into the static input ``dst``, through the plain
        containers :func:`capture` went through."""
        if isinstance(dst, torch.Tensor):
            if not isinstance(src, (torch.Tensor, np.ndarray)):
                raise ValueError(f"{self!r}: an argument of another "
                                 f"structure than the captured one (a "
                                 f"tensor, given {type(src).__name__})")
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{self!r}: a tensor argument of shape "
                                 f"{tuple(src.shape)}, captured with "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        elif type(dst) in (tuple, list, dict):
            if type(src) is not type(dst) or len(src) != len(dst) or (
                    type(dst) is dict and set(src) != set(dst)):
                raise ValueError(f"{self!r}: an argument of another "
                                 f"structure than the captured one")
            for k in (dst if type(dst) is dict else range(len(dst))):
                self._load_one(dst[k], src[k])
        elif not _same_static(dst, src):
            raise ValueError(f"{self!r}: an argument changed from {dst!r} "
                             f"to {src!r}; a captured run is one static "
                             f"configuration: capture again")

    def __call__(self, *args, **kw):
        if args or kw:
            self._load(args, kw)
        self.graph.replay()
        return _fresh(self.out)

    def __repr__(self):
        return f"CapturedRun({getattr(self.fn, '__name__', self.fn)})"


def capture(fn: Callable, gen: torch.Generator, *args, **kw) -> CapturedRun:
    """``fn(gen, *args, **kw)`` captured once as a CUDA graph: the
    counterpart of ``jax.jit(fn)`` for this static configuration.

    - every kernel is built and loaded (``ops/build.py`` ``load_all``);
    - tensor and numpy arguments are copied into static input buffers on
      the generator's card (the graph reads them there at every replay);
    - ``fn`` runs once eagerly on a side stream in its captured form
      (every :func:`device_cond` branch runs and is selected on the
      device); the generator's state is restored after it;
    - one run is captured into a private pool, with ``gen`` registered.

    Raises on a generator that is not on the card, on ``mesh=``, and on a
    generative function that is not
    ``batch_safe`` (found among the arguments, or by the warm-up having
    run the per-particle interpretation): those forms run uncaptured. A
    capture error (a host read, or a host-to-device copy of a Python
    value inside ``fn``) raises as it is."""
    _refuse_uncapturable(fn, args, kw)
    if not isinstance(gen, torch.Generator) or gen.device.type != "cuda":
        raise ValueError(
            f"capture records a CUDA graph and needs a generator on the "
            f"card, got {getattr(gen, 'device', gen)!r}; on the CPU call "
            f"{getattr(fn, '__name__', 'fn')}(gen, ...) uncaptured")
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError(
            f"PyTorch {torch.__version__} lacks torch.cuda.CUDAGraph."
            f"register_generator_state: a captured run draws from the "
            f"caller's generator")
    from ..ops.build import load_all
    load_all()
    device = torch.device("cuda", gen.device.index
                          if gen.device.index is not None
                          else torch.cuda.current_device())

    def static(x):
        x = torch.as_tensor(x)
        if x.device.type == "cuda" and x.device != device:
            raise ValueError(f"capture: a tensor argument on {x.device}, "
                             f"the generator on {device}")
        return x.to(device=device, copy=True)
    s_args, s_kw = _map_inputs((args, kw), static)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(main)
    gen_state = gen.get_state()
    maps = BOUNDARY["calls"]
    with torch.cuda.stream(side), _warming():
        fn(gen, *s_args, **s_kw)
    main.wait_stream(side)
    if BOUNDARY["calls"] != maps:
        raise NotImplementedError(
            f"capture({getattr(fn, '__name__', 'fn')}): the run went through "
            f"the per-particle interpretation (vmap_gfi: a model, proposal "
            f"or translator that is not batch_safe), which runs uncaptured")
    gen.set_state(gen_state)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=side):
        out = fn(gen, *s_args, **s_kw)
    seconds = time.perf_counter() - t0
    pool = torch.cuda.max_memory_allocated(device) - before
    return CapturedRun(fn, graph, (s_args, s_kw), out, seconds, pool)
