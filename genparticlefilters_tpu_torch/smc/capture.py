"""The JAX package's compiled drivers on the card: ``jax.jit`` +
``lax.scan`` + ``lax.cond`` become one captured CUDA graph per filter run.

- :func:`device_cond` is ``lax.cond(pred, branch, lambda s: s, state)``.
  Eager (a CPU predicate, or the card while nothing is being captured) it
  reads ``pred`` on the host and runs ``branch`` or not. While
  :func:`capture` captures a graph it is what XLA's ``conditional`` is
  under ``jit``: a CUDA-graph IF node (``ops/graph_cond.py``) whose THEN
  body runs the branch and copies the leaves it replaced, all in one
  ``copy_leaves`` launch. With ``donate=True`` (XLA giving the dead
  operand's buffers to the result) each replaced leaf is written back
  into the incoming tensor, so an untaken check has no work at all and,
  where every leaf can be donated, the node has no ELSE body. A leaf that
  cannot be donated (one that ``core/packed.py`` ``may_overwrite``
  refuses, or a tensor the state holds twice), and every leaf without
  ``donate``, goes to a fresh buffer, which the THEN body fills from the
  result and an ELSE body from the incoming leaf. At replay only the
  taken body runs and the predicate stays on the card.
  Either way, a branch that returns another structure, leaf shape or
  dtype than it was given raises ``TypeError``, as ``lax.cond`` does.
- ``_select`` is the IF node's plain version, ``lax.cond`` under
  ``vmap``: the branch always runs and each leaf it replaced becomes
  ``torch.where(pred, out, in)``. :func:`capture`'s eager warm-up runs
  every branch through it, and ``_select_form`` makes a capture take it
  (the yardstick the IF form is held against on the card);
  ``_buffered_form`` makes a capture ignore ``donate`` (the IF form
  without donation, timed beside it on the card).
- :func:`host_pred` is where a filter loop reads its predicate: on the
  host (inside the loop's ``ess_check`` span) unless the captured form
  runs. ``host_pred.reads`` counts the host reads: one synchronize per
  ESS check eager, none in a replay.
- :func:`capture` is ``jax.jit`` for one static configuration: it builds
  every kernel, runs ``fn`` once eagerly in its captured form (every
  kernel, library and lazy initialisation meets the card before the
  capture), captures one run into a private memory pool with the
  generator registered, and returns a :class:`CapturedRun`. The filters'
  Python loops unroll under the capture, as ``lax.scan`` is lowered.

A branch draws its random numbers at capture: each draw's Philox offset
is fixed there, taken or not, so a replay's draws after an untaken branch
are those after a taken one. An IF replay is bit-equal to the select
replay from the same seed at any predicate, and to the eager run where
every branch fires. The kernels' ``launches`` counters and
``Unfold.steps_run`` count at capture, not per replay. Per-replay counts
and phase times come from the device spans (``utils/spans.py``): a graph
captured while ``torch.profiler`` runs holds a marker at each span's entry
and exit, one :data:`~..utils.spans.RUN` span around the whole run, so
each replay logs on the card its phases' device ns and, through the
``*.resample`` spans inside the IF bodies, the ESS checks that fired.
Captured without the profiler, the graph holds no marker.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Callable

import numpy as np
import torch

from ..core.batching import BOUNDARY
from ..core.packed import (STORE_WRITES, may_overwrite, static_inputs,
                           storage_of)
from ..core.gfi import GenFn
from ..core.tree import tree_flatten, tree_unflatten
from ..utils.spans import RUN, arm_device_spans, span

__all__ = ["device_cond", "host_pred", "capture", "CapturedRun"]

# > 0 while capture() warms up: device_cond runs its select form eagerly
_WARMING = [0]
# > 0 inside _select_form(): a capture takes the select form
_SELECTING = [0]
# > 0 inside _buffered_form(): a capture ignores donate
_BUFFERING = [0]
# the body streams and pools of the captures under way (capture() pushes)
_BODIES: list = []


def _graph_form(pred) -> bool:
    """Whether ``device_cond`` takes its captured form for ``pred``: a
    graph is being captured on the card, or :func:`capture` warms up."""
    return isinstance(pred, torch.Tensor) and pred.is_cuda and (
        _WARMING[0] > 0 or torch.cuda.is_current_stream_capturing())


def host_pred(pred):
    """``pred`` as a Python bool (one host read, counted in
    ``host_pred.reads``), or the device tensor itself where
    :func:`device_cond` takes its captured form."""
    if _graph_form(pred):
        return pred
    host_pred.reads += 1
    return bool(pred)


#: host reads of a predicate by :func:`host_pred` (on the card, each
#: waits for the queue)
host_pred.reads = 0


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
    """The IF node's plain version: ``branch(state)`` always, then each
    leaf it replaced selected on the device, ``torch.where(pred, out,
    in)``."""
    out = branch(state)
    in_leaves, out_leaves, out_def = _flatten_like(state, out)
    pred = pred.reshape(())
    return tree_unflatten(out_def, [
        torch.where(pred, o, x) if isinstance(o, torch.Tensor) and o is not x
        else o for x, o in zip(in_leaves, out_leaves)])


def _donatable(leaves) -> set:
    """The indices of the tensor leaves of ``leaves`` that a branch's
    result may be written into: empty, or one the core's rule lets a
    writer overwrite (``leaves`` the donating tree) and held in one place
    only (one tensor takes one result)."""
    places = collections.Counter(id(x) for x in leaves)
    return {i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)
            and (x.numel() == 0 or (places[id(x)] == 1
                                    and may_overwrite(x, leaves)))}


def _readable(o, written) -> torch.Tensor:
    """``o`` as a copy source: contiguous, and cloned where its storage is
    one that the same copy writes (a view of a donated leaf), so that one
    launch never reads what it writes."""
    if not o.is_contiguous() or (o.numel() and storage_of(o) in written):
        return o.clone(memory_format=torch.contiguous_format)
    return o


def _if_form(new_node, branch, state, donate=False):
    """``device_cond`` on a conditional node ``new_node(bodies)``. Its THEN
    body runs ``branch(state)`` and copies, in one ``node.copy``, each
    leaf the branch replaced into its destination: with ``donate``, the
    incoming tensor itself where :func:`_donatable` allows it, else a
    buffer from ``node.alloc``, which the ELSE body fills from the incoming
    leaf. The node has an ELSE body only where some tensor leaf of
    ``state`` cannot be donated. The result holds the destinations where
    the branch replaced a leaf, and every other leaf as it came.
    ``node.then(fn)`` and ``node.otherwise(fn)`` capture ``fn``'s work into
    the two bodies (on the card, :class:`_CardNode`); ``node.donated`` and
    ``node.buffered`` count the leaves of each kind."""
    in_leaves, _ = tree_flatten(state)
    own = _donatable(in_leaves) if donate else set()
    one_body = all(i in own for i, x in enumerate(in_leaves)
                   if isinstance(x, torch.Tensor))
    node = new_node(1 if one_body else 2)
    done = {}

    def then_body():
        out = branch(state)
        _, out_leaves, out_def = _flatten_like(state, out)
        replaced = [i for i, (x, o) in enumerate(zip(in_leaves, out_leaves))
                    if isinstance(o, torch.Tensor) and o is not x]
        dsts = {i: in_leaves[i] if i in own else node.alloc(in_leaves[i])
                for i in replaced}
        written = {storage_of(in_leaves[i]) for i in replaced
                   if i in own and in_leaves[i].numel()}
        node.copy(list(dsts.values()),
                  [_readable(out_leaves[i], written) for i in replaced])
        bufs = {i: d for i, d in dsts.items() if i not in own}
        node.donated, node.buffered = len(dsts) - len(bufs), len(bufs)
        done.update(bufs=bufs, out_def=out_def,
                    leaves=[dsts.get(i, o) for i, o in enumerate(out_leaves)])

    def else_body():
        bufs = done["bufs"]
        node.copy(list(bufs.values()),
                  [in_leaves[i].contiguous() for i in bufs])
    node.then(then_body)
    if not one_body:
        node.otherwise(else_body)
    return tree_unflatten(done["out_def"], done["leaves"])


class _Bodies:
    """What one capture's IF nodes share: the stream their bodies are
    captured on and the memory pool their allocations go to. A body's
    capture has its own capture id, so PyTorch's filter, which routes the
    graph's allocations to its pool by capture id, misses it; the pool is
    kept as long as the graph. ``inputs`` holds the storage addresses of
    the capture's static inputs, which no IF node writes; ``nodes`` the IF
    nodes made; ``writes`` the ``STORE_WRITES`` their bodies made, which a
    replay runs only where a check is taken."""

    def __init__(self, device, inputs=frozenset()):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        with torch.cuda.device(device):
            self.pool = torch.cuda.MemPool()
        self.active = False
        self.inputs = inputs
        self.nodes = []
        self.writes = dict.fromkeys(STORE_WRITES, 0)

    def capture(self, graph, fn):
        """``fn()`` with its work captured into the body ``graph`` on the
        body stream, its allocations in the pool."""
        from ..ops.graph_cond import capture_body
        if self.active:
            raise NotImplementedError(
                "device_cond inside a device_cond branch under capture: "
                "nested conditional nodes are not built")
        self.active = True
        writes = dict(STORE_WRITES)
        try:
            with torch.cuda.use_mem_pool(self.pool, self.device), \
                    torch.cuda.stream(self.stream), \
                    capture_body(graph, self.stream):
                fn()
        except TypeError:
            raise
        except Exception as e:
            raise RuntimeError(
                f"device_cond: the branch failed while captured into a "
                f"conditional node's body ({type(e).__name__}: {e}); a body "
                f"holds kernels, memsets, device copies and child graphs, "
                f"no event record or wait (a fork to another stream) and "
                f"no host node; the failing op is in the traceback above"
            ) from e
        finally:
            self.active = False
            for k, v in writes.items():
                self.writes[k] += STORE_WRITES[k] - v


class _CardNode:
    """One IF node with ``bodies`` bodies (1: THEN only, 2: THEN and
    ELSE), captured on ``pred``'s current stream; the buffers are
    allocated there, in the graph's pool, and the bodies copy through
    ``copy_leaves``. ``pred`` is kept: after a replay it holds the value
    that replay's node read."""

    def __init__(self, pred, bodies: _Bodies, n: int):
        from ..ops.graph_cond import if_node
        self.bodies = bodies
        self.pred = pred
        self.outer = torch.cuda.current_stream(pred.device)
        self.graphs = if_node(pred, n)
        self.donated = self.buffered = 0
        bodies.nodes.append(self)

    def alloc(self, x):
        with torch.cuda.stream(self.outer):
            return torch.empty(x.shape, dtype=x.dtype, device=x.device)

    @staticmethod
    def copy(dsts, srcs):
        from ..ops.graph_cond import copy_leaves
        copy_leaves(dsts, srcs)

    def then(self, fn):
        self.bodies.capture(self.graphs[0], fn)

    def otherwise(self, fn):
        self.bodies.capture(self.graphs[1], fn)


def device_cond(pred, branch: Callable, state, donate: bool = False):
    """``branch(state)`` where ``pred`` holds, else ``state``; the
    counterpart of ``lax.cond(pred, branch, lambda s: s, state)``.

    ``pred`` is a Python bool or a one-element bool tensor. Eager, it is
    read on the host. While :func:`capture` captures a graph it stays on
    the card: one CUDA-graph IF node whose THEN body runs the branch and
    copies every leaf it replaced, in one ``copy_leaves`` launch, into its
    place in the result; leaves the branch kept pass as the same objects.
    With ``donate=True`` that place is the incoming tensor itself wherever
    it can be (XLA's buffer donation): the caller promises that ``state``
    is dead after the call, since its tensors then hold the result, and an
    untaken check does nothing. A leaf that cannot be donated, and every
    leaf without ``donate``, goes to a fresh buffer that an ELSE body
    fills from the incoming leaf where the branch is not taken. Eager runs
    and the select form ignore ``donate``. During :func:`capture`'s
    warm-up it is ``_select``. Raises ``TypeError`` where the branch
    changes the structure, a leaf's shape or dtype, or a static leaf, and
    ``RuntimeError`` under a capture not made by :func:`capture` (which
    owns the bodies' stream and pool)."""
    if _graph_form(pred):
        if _WARMING[0] > 0 or _SELECTING[0] > 0:
            return _select(pred, branch, state)
        if not _BODIES:
            raise RuntimeError(
                "device_cond under a CUDA graph capture that capture() did "
                "not make: its conditional node needs the body stream and "
                "pool that capture() sets up")
        bodies = _BODIES[-1]
        return _if_form(lambda n: _CardNode(pred, bodies, n), branch, state,
                        donate and not _BUFFERING[0])
    if not bool(pred):
        return state
    out = branch(state)
    _flatten_like(state, out)
    return out


@contextlib.contextmanager
def _select_form():
    """Inside: a capture takes ``device_cond``'s plain version, the
    select, instead of the IF node (the yardstick on the card)."""
    _SELECTING[0] += 1
    try:
        yield
    finally:
        _SELECTING[0] -= 1


@contextlib.contextmanager
def _buffered_form():
    """Inside: a capture ignores ``donate``, so each IF node buffers every
    leaf its branch replaces (the form the donated one is timed against
    on the card)."""
    _BUFFERING[0] += 1
    try:
        yield
    finally:
        _BUFFERING[0] -= 1


@contextlib.contextmanager
def _under(bodies):
    """Inside: ``bodies`` belong to the capture under way (its warm-up
    too), whose static inputs are registered with the core."""
    _BODIES.append(bodies)
    try:
        with static_inputs(bodies.inputs):
            yield
    finally:
        _BODIES.remove(bodies)


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
    ``pool_bytes`` the device memory the capture's pools reached beyond
    what was allocated before it, ``nodes`` the IF nodes in the graph (one
    per :func:`device_cond`). ``bodies`` keeps the IF bodies' pool as long
    as the graph; :attr:`forms` counts what its nodes hold.
    ``store_writes`` holds the captured run's ``STORE_WRITES``
    (``core/packed.py``) outside the IF bodies, so those of every replay:
    the packed stores it copied whole and wrote in place."""

    def __init__(self, fn, graph, inputs, out, capture_seconds, pool_bytes,
                 nodes=0, bodies=None, store_writes=None):
        self.fn = fn
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.capture_seconds = capture_seconds
        self.pool_bytes = pool_bytes
        self.nodes = nodes
        self.bodies = bodies
        self.store_writes = store_writes

    @property
    def forms(self) -> dict:
        """``{"else_nodes", "donated", "buffered"}``: the IF nodes with an
        ELSE body, and the replaced leaves written back into the incoming
        tensor and into a buffer, over all nodes."""
        nodes = self.bodies.nodes if self.bodies is not None else []
        return {"else_nodes": sum(len(n.graphs) == 2 for n in nodes),
                "donated": sum(n.donated for n in nodes),
                "buffered": sum(n.buffered for n in nodes)}

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
    - ``fn`` runs once eagerly on a side stream with every
      :func:`device_cond` in its select form (every branch runs, so every
      kernel and lazy initialisation meets the card before the capture);
      the generator's state is restored after it;
    - one run is captured into a private pool, with ``gen`` registered,
      each :func:`device_cond` an IF node whose bodies are captured on a
      stream of their own into a second pool, kept with the graph; the
      static inputs' storages are registered with the core
      (``core/packed.py`` ``static_inputs``) for it and the warm-up, so
      that no IF node and no donated update writes them. The run is one
      ``captured.run`` span; where
      ``torch.profiler`` runs, its spans become device markers in the
      graph (``utils/spans.py``), whose library is loaded before the
      capture is timed.

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
    bodies = _Bodies(device, frozenset(
        storage_of(x) for x in _plain_leaves((s_args, s_kw))
        if isinstance(x, torch.Tensor)))
    gen_state = gen.get_state()
    maps = BOUNDARY["calls"]
    with torch.cuda.stream(side), _warming(), _under(bodies):
        fn(gen, *s_args, **s_kw)
    main.wait_stream(side)
    if BOUNDARY["calls"] != maps:
        raise NotImplementedError(
            f"capture({getattr(fn, '__name__', 'fn')}): the run went through "
            f"the per-particle interpretation (vmap_gfi: a model, proposal "
            f"or translator that is not batch_safe), which runs uncaptured")
    gen.set_state(gen_state)
    from ..ops.graph_cond import if_node
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    # the warm-up's garbage freed now, not inside the capture, where it
    # would lower pool_bytes by what it held
    gc.collect()
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    nodes = if_node.launches
    arm_device_spans()
    writes = dict(STORE_WRITES)
    t0 = time.perf_counter()
    with _under(bodies), torch.cuda.graph(
            graph, stream=side, capture_error_mode="global"), span(RUN):
        out = fn(gen, *s_args, **s_kw)
    seconds = time.perf_counter() - t0
    pool = torch.cuda.max_memory_allocated(device) - before
    return CapturedRun(fn, graph, (s_args, s_kw), out, seconds, pool,
                       if_node.launches - nodes, bodies,
                       {k: STORE_WRITES[k] - v - bodies.writes[k]
                        for k, v in writes.items()})
