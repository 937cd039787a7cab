"""The port's ``jax.lax.scan``, ``jax.lax.while_loop`` and ``jax.jit``:
a loop over intervals that runs, on the card, as one captured CUDA graph
replayed once per interval (:func:`scan`, :class:`GraphedScan`), a
function whose every call replays one captured CUDA graph of itself
(:func:`graphed`, the counterpart of ``jax.jit(shard_map(...))`` for the
sharded steps of ``parallel/`` and of the stepwise sites), and a loop
that ends on device data (:func:`while_loop`), whose chunk of masked
iterations such a graph replays until a flag read once a chunk says it
has ended.

The JAX fused layer runs a whole propagation as ONE compiled program: a
``lax.scan`` of the step over the per-interval coefficient table, with
the per-step outputs written into a preallocated array, and an
optimal-control loop calls the same executable with new tables.  Here
the counterpart of ``jax.jit(lax.scan(step))`` is a
:class:`torch.cuda.CUDAGraph` of the step:

- the first interval runs eagerly on a side stream, as a real step: it
  builds the kernels, initialises lazy handles and sizes the buffers;
- one interval is captured with static buffers: the carry, a device
  interval counter, the ``xs`` rows selected inside the graph
  (``index_select`` on the counter) and the ``(length, ...)`` outputs
  written inside it (``index_copy_``); the graph increments the counter;
- a step that takes a keyword ``out`` (a tree shaped like the carry, the
  port's ``donate_argnums``) writes its new carry into those buffers and
  returns them.  Its interval is captured twice, over two carry buffers:
  graph A reads buffer 0 and writes buffer 1, graph B the other way, so
  that no replay copies the carry.  B is captured at its first replay,
  after A's is issued, so that its capture overlaps A's device work:
  two captures in a row outlast the eager first interval of a 2^24
  complex64 step and leave the device idle.  A step without ``out``
  (any step a caller hands to :func:`scan`, as ``lax.scan`` takes any)
  has one graph that ends by copying its new carry into its one buffer:
  one read and one write of the carry, about 2 % of a 2^24 complex128
  step;
- the graphs are replayed ``length − 1`` times (A, B, A, …), with no
  host work per interval beyond the replay call.

A step's ``out`` is ``None`` where it allocates its result (the eager
loop and every first interval); given, the step must write the buffers
before it reads them, leave its input carry as it was, and return the
same values as without it, bit for bit.

Every graph on a device captures into one memory pool kept for the
process (:func:`_graph_pool`), so that a propagation's capture reuses
the blocks of the ones before it.  Replays run on the caller's current
stream; two scans must not replay at once on different streams.

A step that reads the host (``.item()``, ``float(t)``, ``.tolist()``,
``.cpu()``, a pageable host-to-device copy such as a tensor made from a
Python list) cannot be captured: :func:`scan` raises with PyTorch's
message and the step named (after the first interval already when the
step returns a tensor on the host), and never falls back to the loop, as a
``jit`` of an untraceable step fails in JAX.

The kernel wrappers' launch counters (``ops/cheby_flip.py`` and
``ops/banded_spmv.py`` ``LAUNCHES``) are incremented while the step is
captured, once; the scan takes that delta back and adds it on every
replay, so ``LAUNCHES`` stays "launches issued to the device".

On the CPU, while autograd does not record, :func:`scan` is the plain
loop of the same step.  :class:`GraphedScan` keeps its graph between
calls: every call with inputs of the captured shapes copies them into
the static buffers and replays, one capture for every control update.

While autograd records through the carry or ``xs`` (gradients, GRAPE),
the scan is one ``torch.autograd.Function`` (:class:`_Tape`),
differentiated as ``jax.grad`` differentiates ``lax.scan``:

- the forward runs interval 0 eagerly, then one interval captured with
  autograd recording, replayed; a ``saved_tensors_hooks`` pack hook
  writes each tensor autograd saves into a per-interval stack at the
  device counter (the residuals ``lax.scan`` stacks, no recomputation).
  A saved tensor whose storage the interval neither produces nor writes
  (an operator's matrix, a lattice diagonal) is kept once, by reference;
- the backward is a second captured graph, one interval's VJP
  (``torch.autograd.grad`` of the captured interval), whose unpack hook
  reads the stacks at a counter that runs from ``n − 1`` down to 0; each
  replay writes its table row's cotangent into the ``(n, ...)`` gradient
  of ``xs`` and the carry's cotangent into its buffer.

Both graphs share the device's pool and live in the
:class:`GraphedScan` between calls: a GRAPE iteration is ``n`` forward
and ``n`` backward replays.  The stacks (the loop's saved tensors, once)
live as long as the :class:`GraphedScan`, or an output of the scan,
does.  On the CPU the same ``Function`` calls the
same interval functions with no graphs.  Where the carry changes type
at interval 0, that interval keeps its own autograd graph and its VJP
runs eagerly.  Two routes stay the loop: a step that closes over a
tensor requiring grad (its leaves are not inputs of the ``Function``;
also without grad on the inputs, where the first interval's results
require grad), and a backward with ``create_graph=True``, which reruns
the loop's forward from the saved inputs and differentiates it, so
second derivatives are the loop's.  A backward whose residuals a later
forward of the same :class:`GraphedScan` has overwritten takes that
route too.  A VJP that reads the host raises at its capture, naming
the step.

:func:`graphed` follows the same rules for one call of a function
(:class:`Graphed`): eager first call, one capture per key (operator
tensors read in place, per-call inputs and controls copied into static
buffers), a replay and cloned outputs per later call.  While autograd
records through a per-call input or an operator tensor, a call is one
``torch.autograd.Function`` (:class:`_GradCall`), differentiated as
``jax.grad`` differentiates a ``jax.jit`` call: the body and its VJP
once eagerly at a key's first call; then a forward graph whose saved
tensors (the call's residuals) stay in its own pool, where each replay
rewrites them, and a graph of its VJP that reads them there (no copy:
they are the tensors the eager loop would keep); every call replays the
forward, its residuals moved into clones on its node only before a
next call overwrites them, and that node's backward copies them back
where it must and replays the VJP, so that chained calls and one
backward give the loop's gradient.  A tensor read in place (an
operator's amplitude) has its gradient from the VJP like an input; per
call it is the call's sum, over calls the sum of those.  The body runs
as it is on the CPU, inside an enclosing capture or recording, under a
``torch.func`` transform, on a mesh of more than one rank, and for a
backward with ``create_graph=True`` (rerun from the node's inputs).
Operator tensors that require grad are first used on the side stream,
so the backward synchronizes their gradient's stream (PyTorch warns
once that the AccumulateGrad stream differs).

A ``graphed(..., loop=True)`` site's body runs a :func:`while_loop`
(the DP5 integrator's): its capture is cut there into a graph of the
work before the loop, a graph of one chunk of :data:`WHILE_CHUNK`
iterations over the loop's own state buffers, and a graph of the work
after it (:class:`_Segments`).  A call replays the first, the chunk
until its flag reads false and the last; the host reads the flag of
one chunk while the next is already issued (pinned memory and an
event), so the card never waits for the host.  An iteration past the
loop's end is computed and masked (PyTorch 2.11 on the card offers no
conditional graph nodes), so a chunk's size trades those iterations
against reads of the flag.  Under autograd such a site runs its body
(``jax.grad`` refuses a ``while_loop``).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import inspect
import types
import weakref

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import banded_spmv as _banded
from ..ops import cheby_flip as _flip

__all__ = ["scan", "GraphedScan", "graphed", "Graphed", "while_loop"]

_COUNTERS = (_flip.LAUNCHES, _banded.LAUNCHES)
_SIDE_STREAMS: dict = {}
_POOLS: dict = {}


def _leaves(tree) -> list:
    """The tensors of a tensor, a (nested) tuple or list of tensors, or
    ``None``, in order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    raise TypeError(f"scan takes tensors, tuples or lists of them, or "
                    f"None; got {type(tree).__name__}")


def _map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching tensors of
    ``rest``), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    raise TypeError(f"scan takes tensors, tuples or lists of them, or "
                    f"None; got {type(tree).__name__}")


def _length(xs, length) -> int:
    rows = {int(t.shape[0]) for t in _leaves(xs)}
    if len(rows) > 1:
        raise ValueError(f"xs leaves have different leading axes: {rows}")
    if length is None:
        if not rows:
            raise ValueError("scan needs xs or length")
        return rows.pop()
    if rows and rows.pop() != length:
        raise ValueError(f"length={length} disagrees with the leading axis "
                         f"of xs")
    return int(length)


def _records_grad(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in _leaves(tree))


def _on_card(carry, xs) -> bool:
    leaves = _leaves(carry) + _leaves(xs)
    if not leaves:
        raise ValueError("scan needs at least one tensor in carry or xs")
    return leaves[0].device.type == "cuda"


def _loop(step, carry, xs, n, k0=0, ys=()):
    """The plain loop: ``step`` per interval from ``k0`` on (after the
    outputs ``ys`` of the intervals before it), outputs stacked."""
    ys = list(ys)
    for k in range(k0, n):
        carry, y = step(carry, _map(lambda t: t[k], xs))
        ys.append(y)
    if n == 0 or ys[0] is None:
        return carry, None
    return carry, _map(lambda *rows: torch.stack(rows), ys[0], *ys[1:])


def scan(step, carry, xs=None, length=None):
    """``jax.lax.scan`` on the port: ``step(carry, x) -> (carry, y)`` for
    each row ``x`` of ``xs`` (a tensor or tuple of tensors whose leading
    axis is the interval; ``None`` with ``length``).  Returns the final
    carry and the ``y`` stacked over intervals (``None`` when the step
    returns none).

    On the card the step runs as a replayed CUDA graph (module
    docstring); its carry must keep its shapes and dtypes from the
    second interval on, and ``xs`` must lie on the carry's device."""
    return GraphedScan(step)._run(carry, xs, length)[0]


class GraphedScan:
    """A :func:`scan` of ``step`` whose graph outlives the call: the first
    call on the card captures, and every later call whose carry and
    ``xs`` have the captured shapes and dtypes copies them into the
    static buffers and replays (``length`` times from interval 0, or,
    when the carry's type changes at the first interval, the first
    interval eagerly and ``length − 1`` replays).  A step that takes
    ``out`` replays two graphs in turn, each writing its new carry into
    the other's carry buffer; any other step one graph that copies its
    new carry into its buffer (module docstring).  A step without ``xs``
    and outputs replays for any ``length``; other shapes capture anew.
    While autograd records through the carry or ``xs`` it keeps a
    :class:`_Tape` under the same rules (on the card a second pair of
    graphs, forward and backward; on the CPU too, with no graphs);
    otherwise on the CPU it is :func:`scan`.  The graph reads the
    tensors the step closes over as they were at its capture: one that
    comes to require grad later needs a new :class:`GraphedScan`.  The
    results are returned as new tensors: the next call overwrites the
    static buffers."""

    def __init__(self, step):
        self.step = step
        self._graph = None
        self._tape = None

    def __call__(self, carry, xs=None, length=None):
        out, static = self._run(carry, xs, length)
        if not static:
            return out
        return _map(torch.clone, out[0]), _map(torch.clone, out[1])

    def _run(self, carry, xs, length):
        """``(carry, ys)`` and whether they are the graph's static
        buffers."""
        n = _length(xs, length)
        if n > 0 and _records_grad(carry, xs):
            return self._differentiated(carry, xs, n), False
        if n == 0 or not _on_card(carry, xs):
            return _loop(self.step, carry, xs, n), False
        key = (_signature(carry), _signature(xs))
        graph = self._graph
        if graph is not None and graph.key == key and (
                graph.n == n or not _leaves(graph.ys)):
            return graph.rerun(carry, xs, n), True
        self._graph = None  # its blocks go back to the pool first
        graph = _Graph(self.step, key)
        out = graph.run(carry, xs, n)
        if not graph.bufs:  # autograd recorded: the loop ran
            return out, False
        self._graph = graph
        return out, True

    def _differentiated(self, carry, xs, n):
        """The scan as one autograd node (:class:`_Tape`), or the loop
        where the step closes over a tensor that requires grad or a
        ``torch.func`` transform is active."""
        if torch._C._are_functorch_transforms_active():
            return _loop(self.step, carry, xs, n)
        key = (_signature(carry), _signature(xs),
               tuple(t.requires_grad for t in _leaves(xs)))
        tape = self._tape
        if tape is None or tape.key != key or tape.n != n:
            self._tape = None  # its blocks go back to the pool first
            tape = _Tape(self.step, key, n, _device(carry, xs))
        if not tape.run(carry, xs):
            return _loop(self.step, carry, xs, n)
        self._tape = tape
        return tape.apply(carry, xs)


def _signature(tree):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in _leaves(tree))


def _device(carry, xs) -> torch.device:
    leaves = _leaves(carry) + _leaves(xs)
    device = leaves[0].device
    for t in leaves:
        if t.device != device:
            raise ValueError(f"scan needs carry and xs on one device; got "
                             f"{t.device} and {device}")
    return device


def _first_on_side(step, device, fn, what="scan"):
    """``fn()``, the first interval ``(carry, y)`` of ``step`` (or the
    first call of a :class:`Graphed` body and ``None``), run eagerly on
    the device's side stream (where the captures run: the one-time
    constants it makes belong to that stream)."""
    cur = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        carry1, y0 = fn()
    cur.wait_stream(side)
    for t in _leaves(carry1) + _leaves(y0):
        if t.device != device:
            raise RuntimeError(_refused(
                step, f"it returns a tensor on {t.device}", what))
        t.record_stream(cur)
    return carry1, y0


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _side_stream(device) -> torch.cuda.Stream:
    index = _index(device)
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def _graph_pool(device):
    """The memory pool every scan's graph on ``device`` captures into,
    kept for the process by a one-node graph captured into it first.  A
    graph's own pool would hold its step's temporaries after the graph
    is gone, until an allocation fails and the allocator frees every
    cached block at once; one pool serves each new capture from the
    blocks of the graphs before it.  Graphs may share it because nothing
    of a step outlives its replay in the pool: the carry, ``xs``,
    outputs and counter are static buffers outside it, and replays run
    in order on the caller's stream."""
    index = _index(device)
    if index not in _POOLS:
        handle = torch.cuda.graph_pool_handle()
        keeper = torch.cuda.CUDAGraph()
        with torch.cuda.device(index), torch.cuda.stream(_side_stream(index)):
            keeper.capture_begin(pool=handle)
            torch.zeros(1, device=torch.device("cuda", index))
            keeper.capture_end()
        _POOLS[index] = (handle, keeper)
    return _POOLS[index][0]


def _name(step) -> str:
    return getattr(step, "__qualname__", None) or repr(step)


def _refused(step, why, what="scan") -> str:
    return (f"{what}: step {_name(step)} cannot be captured as a CUDA graph "
            f"(a step on the card must not read the host): {why}")


#: :func:`_captured`'s ``pool`` for a graph with a pool of its own
_OWN_POOL = "own"


def _captured(device, fn, refused, pool=None, split=False):
    """``fn()`` captured as a CUDA graph on the device's side stream into
    ``pool``: the shared pool (``None``), a pool of its own
    (:data:`_OWN_POOL`: for a graph whose tensors outlive its replay,
    which no other graph may reuse) or a graph's ``pool()`` (capturing
    runs nothing on the device).  Returns the
    graph, what ``fn`` returned and the launches one replay issues (the
    counters' delta over the capture, which is taken back).  With
    ``split``, each :func:`while_loop` that ``fn`` runs cuts the capture
    (:class:`_Segments`), which is returned in place of the graph, with
    its own deltas.  A failed
    capture raises ``RuntimeError(refused(exc))``, or :class:`_NotOut`
    as it is.  The garbage collector is held off while it captures: a
    graph it destroyed then (one left in a reference cycle, such as an
    exception's traceback) would end the capture with "operation not
    permitted when stream is capturing"."""
    cur = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(cur)
    before = [dict(c) for c in _COUNTERS]
    pool = _graph_pool(device) if pool is None else \
        torch.cuda.graph_pool_handle() if pool == _OWN_POOL else pool
    segments = _Segments(pool, before)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            segments.begin()
            if split:
                _Segments.active = segments
            try:
                out = fn()
            except Exception as exc:
                try:
                    segments.graph.capture_end()
                except RuntimeError:
                    # the capture was already invalidated by exc, and the
                    # allocator still counts it as under way: end that,
                    # or it keeps routing this stream's allocations to
                    # the pool and keeps every freed block cached for
                    # good (empty_cache frees nothing); capture on a new
                    # stream into a new pool from now on
                    index = _index(device)
                    try:
                        torch._C._cuda_endAllocateToPool(index, pool)
                    except RuntimeError:
                        pass  # capture_end got that far itself
                    _SIDE_STREAMS.pop(index, None)
                    _POOLS.pop(index, None)
                if isinstance(exc, _NotOut):
                    raise
                raise RuntimeError(refused(exc)) from exc
            finally:
                _Segments.active = None
            delta = segments.end()
    finally:
        if collecting:
            gc.enable()
        for c, b in zip(_COUNTERS, before):
            c.update(b)
    cur.wait_stream(side)
    if split:
        return segments, out, ()
    return segments.graph, out, delta


class _Segments:
    """A capture cut by :func:`while_loop` into the graphs one call
    replays in order: straight graphs (run once) and, between them, one
    graph of each loop's chunk, replayed until its flag reads false
    (:meth:`replay`).  ``parts`` holds ``(graph, delta, loop)``, ``loop``
    being ``None`` for a straight graph and ``(flag, state)`` for a
    chunk: the 0-d bool ``cond`` of the loop's state after the chunk,
    and that state (the loop's static buffers, which every replay of the
    chunk rewrites in place)."""

    #: the capture under way that a :func:`while_loop` may cut
    active = None

    def __init__(self, pool, before):
        self.pool = pool
        self.before = before     # the launch counters at the capture's start
        self.parts = []
        self.graph = None        # the graph being captured
        self._loop = None
        self._pins = None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self._loop = None
        self.graph.capture_begin(pool=self.pool)

    def end(self):
        """Ends the graph being captured; returns its launches (taken
        back)."""
        self.graph.capture_end()
        delta = tuple((c, k, c[k] - b[k])
                      for c, b in zip(_COUNTERS, self.before)
                      for k in c if c[k] != b[k])
        for c, b in zip(_COUNTERS, self.before):
            c.update(b)
        self.parts.append((self.graph, delta, self._loop))
        return delta

    def loop(self, cond, body, state):
        """A :func:`while_loop` inside the capture: the state copied into
        buffers of the loop's own (in the straight graph before it), one
        chunk of :data:`WHILE_CHUNK` masked iterations captured as a graph
        that writes its result back into them and computes the flag, and
        the straight graph after it begun with copies of the final
        state."""
        state = tuple(torch.clone(s) for s in state)
        self.end()     # the straight graph before the loop
        self.begin()   # the chunk
        new = _chunk(cond, body, state)
        for s, n in zip(state, new):
            s.copy_(n)
        self._loop = (cond(state), state)
        self.end()
        self.begin()   # the straight graph after it
        return tuple(torch.clone(s) for s in state)

    def replay(self):
        """Each graph in order, a chunk until its flag reads false.  A
        chunk's flag comes back through pinned memory and an event while
        the next chunk is already issued, so the device never waits for
        the host; one chunk more than the loop needs is issued, and
        changes nothing."""
        for graph, delta, loop in self.parts:
            if loop is None:
                graph.replay()
                _add_launches(delta)
            else:
                self._spin(graph, delta, loop[0])

    def _spin(self, graph, delta, flag):
        if self._pins is None:
            self._pins = [torch.empty((), dtype=torch.bool, pin_memory=True)
                          for _ in range(2)]
            self._events = [torch.cuda.Event() for _ in range(2)]
        pins, events = self._pins, self._events

        def issue(slot):
            graph.replay()
            _add_launches(delta)
            pins[slot].copy_(flag, non_blocking=True)
            events[slot].record()

        issue(0)
        slot = 0
        while True:
            issue(1 - slot)
            events[slot].synchronize()
            FLAG_READS["graph"] += 1
            if not bool(pins[slot]):
                return
            slot = 1 - slot


def _add_launches(delta, times=1):
    for counts, key, d in delta:
        counts[key] += d * times


class _NotOut(ValueError):
    """A step that takes ``out`` returned other tensors as its carry."""


def _takes_out(step) -> bool:
    """Whether ``step`` takes a keyword ``out`` (module docstring)."""
    try:
        param = inspect.signature(step).parameters.get("out")
    except (TypeError, ValueError):  # a callable without a signature
        return False
    return param is not None and param.kind in (
        inspect.Parameter.POSITIONAL_OR_KEYWORD,
        inspect.Parameter.KEYWORD_ONLY)


def _is_out(state, out) -> bool:
    """Whether the leaves of ``state`` are the buffers of ``out``: the
    same memory, shape, strides and dtype."""
    a, b = _leaves(state), _leaves(out)
    return len(a) == len(b) and all(
        s.data_ptr() == o.data_ptr() and s.shape == o.shape
        and s.stride() == o.stride() and s.dtype == o.dtype
        for s, o in zip(a, b))


class _Graph:
    """One interval of ``step`` captured over its static buffers: for a
    step that takes ``out``, two graphs over two carry buffers, A from
    buffer 0 into buffer 1 and B back; for any other step one graph that
    copies its new carry into its one buffer."""

    def __init__(self, step, key):
        self.step = step
        self.key = key           # the carry's and xs's shapes and dtypes
        self.pairs = ()          # (read, write) carry buffers of each graph
        self.graphs = []         # the CUDAGraphs, A (and B), once captured
        self.deltas = []         # launches one replay of each issues
        self.carry_copies = None  # carry leaves one replay copies
        self.n = None            # intervals of the capturing call
        self.bufs = ()           # static carry buffers, the carry in bufs[0]
        self.xs = None           # static xs
        self.ys = None           # (n, ...) outputs
        self.counter = None      # (1,) int64: the interval being run
        self.first_eager = False
        self.device = None

    def run(self, carry, xs, n):
        """Interval 0 eagerly, the capture, then ``n − 1`` intervals
        replayed.  Where the first interval's results require grad, the
        loop from interval 1 instead, and nothing is captured."""
        device = self.device = _device(carry, xs)
        carry1, y0 = _first_on_side(
            self.step, device, lambda: self.step(carry, _map(lambda t: t[0],
                                                             xs)))
        if _records_grad(carry1, y0):
            # the step closes over a tensor that requires grad
            return _loop(self.step, carry1, xs, n, 1, [y0])
        self.first_eager = _signature(carry1) != _signature(carry)
        self.n = n
        # both buffers outside any capture: a replay's carry must outlive
        # the pool's temporaries, which the other graph reuses
        a = _map(torch.clone, carry1)
        if _takes_out(self.step):
            b = _map(torch.empty_like, a)
            self.bufs, self.pairs = (a, b), ((a, b), (b, a))
            self.carry_copies = 0
        else:
            self.bufs, self.pairs = (a,), ((a, None),)
            self.carry_copies = len(_leaves(a))
        self.xs = _map(torch.clone, xs)
        self.ys = _map(lambda t: t.new_empty((n,) + tuple(t.shape)), y0)
        _map(lambda buf, t: buf[0].copy_(t), self.ys, y0)
        self.counter = torch.ones(1, dtype=torch.int64, device=device)
        del carry1, y0
        self._capture()
        return self._replay(n - 1), self.ys

    def rerun(self, carry, xs, n):
        """A later call: new inputs into the static buffers, then the
        replays (the first interval eagerly where its carry changes
        type)."""
        _map(lambda buf, t: buf.copy_(t), self.xs, xs)
        if self.first_eager:
            carry1, y0 = self.step(carry, _map(lambda t: t[0], xs))
            _map(lambda buf, t: buf.copy_(t), self.bufs[0], carry1)
            _map(lambda buf, t: buf[0].copy_(t), self.ys, y0)
            self.counter.fill_(1)
            return self._replay(n - 1), self.ys
        _map(lambda buf, t: buf.copy_(t), self.bufs[0], carry)
        self.counter.fill_(0)
        return self._replay(n), self.ys

    def _replay(self, times):
        """``times`` replays from the carry in buffer 0, the graphs in
        turn; returns the buffer that holds the last carry.  Graph B is
        captured where it is first needed, after graph A's replay is
        issued, so that its capture overlaps A's work on the device."""
        for k in range(times):
            g = k % len(self.pairs)
            if g == len(self.graphs):
                self._capture()
            self.graphs[g].replay()
            _add_launches(self.deltas[g])
        return self.bufs[times % len(self.bufs)]

    def _capture(self):
        """The next graph of one interval from the static buffers: it
        selects its ``xs`` row and writes its outputs at the counter and
        increments it.  Of two buffers (a step that takes ``out``) graph
        A reads buffer 0 and has the step write buffer 1, graph B the
        other way, and the step must return those buffers (else
        :class:`_NotOut`); with one, the graph copies the step's new
        carry into it.  Capturing runs nothing on the device.  Keeps the
        launches one replay issues."""
        src, dst = self.pairs[len(self.graphs)]

        def interval():
            x = _map(lambda t: t.index_select(0, self.counter)[0], self.xs)
            if dst is None:
                state, y = self.step(src, x)
                if _signature(state) != _signature(src):
                    raise ValueError(
                        f"the carry changed from {_signature(src)} to "
                        f"{_signature(state)}")
            else:
                state, y = self.step(src, x, out=dst)
                if not _is_out(state, dst):
                    name = getattr(self.step, "__qualname__", None) \
                        or repr(self.step)
                    raise _NotOut(
                        f"scan: step {name} takes out= but returned other "
                        f"tensors as its carry ({_signature(state)}, not "
                        f"the given buffers {_signature(dst)})")
            _map(lambda buf, t: buf.index_copy_(0, self.counter, t[None]),
                 self.ys, y)
            self.counter.add_(1)
            if dst is None:
                _map(lambda buf, t: buf.copy_(t), src, state)

        graph, _, delta = _captured(self.device, interval,
                                    lambda exc: _refused(self.step, exc))
        self.graphs.append(graph)
        self.deltas.append(delta)


# -- the scan under autograd: jax.grad of lax.scan -------------------------

_LIFT_FRESH = torch.ops.aten.lift_fresh.default


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _differentiable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _unflatten(tree, leaves):
    """``tree``'s structure (tensors, or any other leaf) over ``leaves``,
    in order."""
    return _build(tree, iter(leaves))


def _build(node, it):
    # no closure over itself: a recursive nested function is a reference
    # cycle, which would hold the results (and their autograd graph)
    # until the garbage collector runs
    if node is None:
        return None
    if isinstance(node, (tuple, list)):
        return type(node)(_build(u, it) for u in node)
    return next(it)


class _Writes(TorchDispatchMode):
    """The storages written by the operations run under it: their new
    outputs, the tensors they change in place (a view writes nothing)
    and tensors made from host data (``torch.tensor``, ``as_tensor``,
    ``from_numpy``: ``lift_fresh``)."""

    def __init__(self):
        super().__init__()
        self.storages = set()

    @classmethod
    def _should_skip_dynamo(cls):
        # nothing is compiled under it: no Dynamo guard around the
        # dispatch (whose first use imports Dynamo, seconds)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        given = dict(zip((a.name for a in schema.arguments), args), **kwargs)
        for arg in schema.arguments:
            if arg.alias_info is not None and arg.alias_info.is_write:
                self._add(given.get(arg.name))
        outs = out if len(schema.returns) > 1 else (out,)
        for ret, value in zip(schema.returns, outs):
            if ret.alias_info is None or func is _LIFT_FRESH:
                self._add(value)
        return out

    def _add(self, value):
        for t in value if isinstance(value, (tuple, list)) else (value,):
            if isinstance(t, torch.Tensor):
                self.storages.add(_storage(t))


class _Saved:
    """The tensors autograd saves in one interval, kept per interval as
    ``lax.scan`` keeps its residuals.  A saved tensor whose storage the
    interval produces (its inputs, any storage it writes) is a view of a
    stack ``(slots, words)`` of that storage's bytes, copied once an
    interval at ``write_at`` however many views of it are saved (as the
    loop keeps each saved storage once); one the interval only reads (an
    operator's matrix) is kept itself, once.  The first interval
    recorded fixes the entries, one per saved tensor in the order the
    interval saves them; every later one must save alike (the second is
    also watched for writes to a tensor kept itself; later ones follow
    the entries unwatched).  Unpacking reads a stack at ``read_at`` (a
    view of the one slot where there is one).  ``in_place`` (one slot):
    a produced storage is kept itself, its stack a view of it, rebound
    at every recording (a captured call's saves, which its replays
    rewrite in place).  :attr:`depth` counts the recordings under way: a
    :class:`Graphed` call inside one runs its body, whose saves are the
    recording's own."""

    depth = 0

    def __init__(self, step, slots, write_at, read_at, in_place=False):
        self.step = step
        self.slots = slots
        self.in_place = in_place
        self.write_at = write_at   # (1,) int64: the interval being run
        self.read_at = read_at     # (1,) int64: the interval differentiated
        self.stacks = []           # (slots, words), one per storage
        self.entries = []          # (stack index, dtype, shape, stride,
        #                            offset), or (None, the tensor kept)
        self.fixed = False
        self.runs = 0              # intervals recorded
        self._pos = 0
        self._inputs = set()
        self._writes = None
        self._copied = {}          # stack index -> its storage this run
        self._stacked = {}         # storage -> (stack index, weak ref)

    @classmethod
    def grown(cls, first, slots, write_at, read_at):
        """The entries of ``first`` (one slot, interval 0's) with
        ``slots`` slots, interval 0's in slot 0; each of ``first``'s
        stacks is freed once copied."""
        saved = cls(first.step, slots, write_at, read_at)
        for i, stack in enumerate(first.stacks):
            grown = stack.new_empty((slots,) + tuple(stack.shape[1:]))
            grown[0].copy_(stack[0])
            first.stacks[i] = None
            saved.stacks.append(grown)
        saved.entries = list(first.entries)
        saved.fixed, saved.runs = True, first.runs
        return saved

    @contextlib.contextmanager
    def recording(self, inputs):
        """Saves of the interval run inside it go into the entries;
        ``inputs`` are its leaves."""
        self._pos = 0
        self._inputs = {_storage(t) for t in inputs}
        self._copied = {}
        self._writes = _Writes() if self.runs < 2 else None
        _Saved.depth += 1
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack), \
                    self._writes or contextlib.nullcontext():
                yield
        finally:
            _Saved.depth -= 1
        if self.fixed and self._pos != len(self.entries):
            self._differs(f"{self._pos} tensors saved, {len(self.entries)} "
                          f"before")
        for b, *view in self.entries if self._writes else ():
            t = view[0]
            if b is None and _storage(t) in self._writes.storages:
                self._differs(f"a saved {tuple(t.shape)} {t.dtype} tensor "
                              f"is written after it was saved")
        self.fixed = True
        self.runs += 1
        self._writes = self._copied = None
        self._stacked = {}

    def _differs(self, why):
        name = getattr(self.step, "__qualname__", None) or repr(self.step)
        raise RuntimeError(f"scan: step {name} cannot be differentiated "
                           f"interval by interval: {why}")

    def _pack(self, t):
        pos = self._pos
        self._pos += 1
        key = _storage(t)
        if not self.fixed:
            produced = t.device == self.write_at.device and (
                key in self._inputs or key in self._writes.storages)
            self.entries.append(self._new_entry(t) if produced
                                else (None, t))
        if pos >= len(self.entries):
            self._differs(f"more than {len(self.entries)} tensors saved")
        b, *view = self.entries[pos]
        if b is None:
            kept = view[0]
            if t.device == self.write_at.device and (
                    t.data_ptr(), t.shape, t.stride(), t.dtype) != (
                    kept.data_ptr(), kept.shape, kept.stride(), kept.dtype):
                self._differs(f"saved tensor {pos} is not the one saved "
                              f"before")
            return pos
        if view != [t.dtype, tuple(t.shape), t.stride(), t.storage_offset()]:
            self._differs(f"saved tensor {pos} is {tuple(t.shape)} {t.dtype}"
                          f", before {tuple(view[1])} {view[0]}")
        if b not in self._copied:
            stack, words = self.stacks[b], _words(t)
            if words.shape != stack.shape[1:] or words.dtype != stack.dtype:
                self._differs(f"saved tensor {pos} lies in a storage of "
                              f"another size")
            if self.in_place:
                self.stacks[b] = words[None]
            else:
                with torch.no_grad():
                    stack.index_copy_(0, self.write_at, words[None])
            self._copied[b] = key
        elif self._copied[b] != key:
            self._differs(f"saved tensor {pos} lies in another storage")
        return pos

    def _new_entry(self, t):
        """The entry of a produced tensor: a view of the stack of its
        storage, a new stack unless a tensor saved before in this
        interval lies in the same storage, still alive."""
        key = _storage(t)
        b, alive = self._stacked.get(key, (None, None))
        if b is None or alive.expired():
            b = len(self.stacks)
            words = _words(t)
            self.stacks.append(words[None] if self.in_place else
                               words.new_empty((self.slots,) + words.shape))
            self._stacked[key] = (b, StorageWeakRef(t.untyped_storage()))
        return (b, t.dtype, tuple(t.shape), t.stride(), t.storage_offset())

    def _unpack(self, pos):
        b, *view = self.entries[pos]
        if b is None:
            return view[0]
        dtype, shape, stride, offset = view
        stack = self.stacks[b]
        row = stack[0] if self.slots == 1 else \
            stack.index_select(0, self.read_at)[0]
        return row.view(dtype).as_strided(shape, stride, offset)


def _words(t):
    """The whole storage of ``t`` as a flat tensor of 8-byte words (of
    bytes where its size is no multiple of 8): copied by wide loads."""
    storage = t.untyped_storage()
    dtype = torch.int64 if storage.nbytes() % 8 == 0 else torch.uint8
    return torch.empty(0, dtype=dtype, device=t.device).set_(storage)


class _Record:
    """One interval run with autograd recording: its leaves and results
    (and its own saves, where its VJP runs eagerly)."""

    def __init__(self, carry, x, state, y, saved=None):
        self.carry, self.x, self.state, self.y = carry, x, state, y
        self.saved = saved

    def closes_over_grad(self) -> bool:
        """Whether the results depend on a tensor requiring grad other
        than the leaves: the step closes over one."""
        ours = _leaves(self.carry) + _leaves(self.x)
        nodes = []
        for t in _leaves(self.state) + _leaves(self.y):
            if t.grad_fn is not None:
                nodes.append(t.grad_fn)
            elif t.requires_grad and not any(t is u for u in ours):
                return True
        # the history of a leaf that is a non-leaf tensor (an operator
        # tensor a Graphed call reads in place) is not the step's
        seen = {u.grad_fn for u in ours if u.grad_fn is not None}
        while nodes:
            node = nodes.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if hasattr(node, "variable"):  # AccumulateGrad of a leaf
                if not any(node.variable is u for u in ours):
                    return True
                continue
            nodes.extend(fn for fn, _ in node.next_functions)
        return False


def _leaf(t, grad):
    return t.detach().requires_grad_(grad and _differentiable(t))


def _compact(t):
    """``t``, or a copy of it where it is not the whole of its storage in
    order: interval 0's leaves lie in storages like those of the static
    buffers, so that its saves fit the stacks."""
    if t.is_contiguous() and t.storage_offset() == 0 and \
            t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _Tape:
    """The scan of ``step`` over ``n`` intervals as one autograd node
    (module docstring): the forward records each interval's saves into
    :class:`_Saved` stacks, the backward runs one interval's VJP per
    interval from the last to the first.  On the card both are captured
    CUDA graphs, replayed; on the CPU the same interval functions are
    called.  :meth:`run` does the forward, :meth:`apply` returns its
    results as outputs of :class:`_ScanVJP`."""

    def __init__(self, step, key, n, device):
        self.step, self.key, self.n, self.device = step, key, n, device
        self.xs_grad = key[2]    # which xs leaves require grad
        self.on_card = device.type == "cuda"
        self.generation = 0      # forwards run: a backward reads its own
        self.started = False
        self.tpl = None          # the captured (last, on the CPU) interval
        self.first = None        # interval 0's record, its VJP eager
        self.first_eager = False
        self.graph = self.vjp_graph = None
        self.delta = self.vjp_delta = ()

    # -- forward ----------------------------------------------------------

    def run(self, carry, xs) -> bool:
        """The forward into the static buffers; ``False`` (and nothing
        kept) where the step closes over a tensor requiring grad."""
        first = None
        if not self.started or self.first_eager:
            first = self._first(carry, xs)
            if first.closes_over_grad():
                return False
        self.generation += 1
        if not self.started:
            self._start(carry, xs, first)
            return True
        with torch.no_grad():
            _map(lambda buf, t: buf.copy_(t), self.xs, xs)
            if first is not None:
                self.first = first
                _map(lambda buf, t: buf.copy_(t.detach()), self.carry,
                     first.state)
                _map(lambda buf, t: buf[0].copy_(t.detach()), self.ys,
                     first.y)
                self.counter.fill_(1)
            else:
                _map(lambda buf, t: buf.copy_(t), self.carry, carry)
                self.counter.fill_(0)
        self._forward(self.n - (first is not None))
        return True

    def _first(self, carry, xs):
        """Interval 0 eagerly with autograd recording into a one-slot
        :class:`_Saved` (on the card on the side stream)."""
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        saved = _Saved(self.step, 1, zero, zero)
        c = _map(lambda t: _leaf(_compact(t), True), carry)
        x = _map(lambda t: _leaf(_compact(t[0]), t.requires_grad), xs)

        def interval():
            with torch.enable_grad(), saved.recording(_leaves(c)
                                                      + _leaves(x)):
                return self.step(c, x)

        state, y = _first_on_side(self.step, self.device, interval) \
            if self.on_card else interval()
        return _Record(c, x, state, y, saved)

    def _start(self, carry, xs, first):
        """The first call after interval 0: static buffers, the stacks
        (interval 0's in slot 0 unless its carry changes type), then on
        the card both captures and ``n − 1`` forward replays."""
        n, device = self.n, self.device
        self.started = True
        self.trees = (_map(lambda t: True, carry), _map(lambda t: True, xs))
        self.first_eager = _signature(first.state) != _signature(carry)
        with torch.no_grad():
            self.carry = _map(lambda t: t.detach().clone(), first.state)
            self.xs = _map(lambda t: t.detach().clone(), xs)
            self.ys = _map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                           first.y)
            _map(lambda buf, t: buf[0].copy_(t.detach()), self.ys, first.y)
            self.gc = [torch.zeros_like(t) if _differentiable(t) else None
                       for t in _leaves(self.carry)]
            self.gys = [torch.zeros_like(t) if _differentiable(t) else None
                        for t in _leaves(self.ys)]
            self.gxs = [torch.zeros_like(t) if g else None
                        for t, g in zip(_leaves(self.xs), self.xs_grad)]
        self.counter = torch.ones(1, dtype=torch.int64, device=device)
        self.bcounter = torch.zeros(1, dtype=torch.int64, device=device)
        if self.first_eager:
            self.first = first
            self.saved = _Saved(self.step, n, self.counter, self.bcounter)
        else:
            self.saved = _Saved.grown(first.saved, n, self.counter,
                                      self.bcounter)
        del first
        if not self.on_card:
            self._forward(n - 1)
            return
        self.graph, _, self.delta = _captured(
            device, self._interval, lambda exc: _refused(self.step, exc))
        self._forward(n - 1)
        # one VJP run eagerly first, as the forward's interval 0: the
        # backward's kernels, library handles and the autograd engine's
        # device thread come up outside the capture (what it writes, the
        # backward overwrites)
        cur, side = torch.cuda.current_stream(device), _side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.bcounter.fill_(n - 1)
            self._vjp_interval()
        cur.wait_stream(side)
        self.vjp_graph, _, self.vjp_delta = _captured(
            device, self._vjp_interval,
            lambda exc: _refused(self.step, exc, "scan backward"))

    def _interval(self):
        """One interval from the static buffers with autograd recording
        into the stacks at the counter; kept as the template of the
        VJP."""
        c = _map(lambda buf: _leaf(buf, True), self.carry)
        x = _unflatten(self.xs, [
            _leaf(buf.index_select(0, self.counter)[0], g)
            for buf, g in zip(_leaves(self.xs), self.xs_grad)])
        with torch.enable_grad(), self.saved.recording(_leaves(c)
                                                       + _leaves(x)):
            state, y = self.step(c, x)
        if _signature(state) != _signature(self.carry):
            raise ValueError(f"the carry changed from "
                             f"{_signature(self.carry)} to "
                             f"{_signature(state)}")
        with torch.no_grad():
            _map(lambda buf, t: buf.index_copy_(0, self.counter,
                                                t.detach()[None]),
                 self.ys, y)
            self.counter.add_(1)
            _map(lambda buf, t: buf.copy_(t.detach()), self.carry, state)
        self.tpl = _Record(c, x, state, y)

    def _forward(self, times):
        if self.on_card:
            for _ in range(times):
                self.graph.replay()
            _add_launches(self.delta, times)
        else:
            for _ in range(times):
                self._interval()

    def apply(self, carry, xs):
        """The forward's results as outputs of :class:`_ScanVJP` (new
        tensors), in ``(carry, ys)`` structure."""
        outs = _ScanVJP.apply(self, *_leaves(carry), *_leaves(xs))
        nc = len(_leaves(self.carry))
        return (_unflatten(self.carry, outs[:nc]),
                _unflatten(self.ys, outs[nc:]))

    # -- backward ---------------------------------------------------------

    def backward(self, grads, needs):
        """The cotangents of the inputs (carry leaves, then ``xs``
        leaves; ``None`` where ``needs`` is false) from those of the
        outputs, by one VJP per interval from the last to the first."""
        with torch.no_grad():
            for buf, g in zip(self.gc + self.gys, grads):
                if buf is not None:
                    buf.copy_(g)
            self.bcounter.fill_(self.n - 1)
        times = self.n - (self.first is not None)
        if self.on_card:
            for _ in range(times):
                self.vjp_graph.replay()
            _add_launches(self.vjp_delta, times)
        else:
            for _ in range(times):
                self._vjp_interval()
        if self.first is not None:  # bcounter is 0
            g_carry, g_xs = self._vjp(self.first)
            self._write_xs(g_xs)
        else:
            g_carry = [None if g is None else g.clone() for g in self.gc]
        g_xs = [None if g is None else g.clone() for g in self.gxs]
        return tuple(g if need else None
                     for g, need in zip(list(g_carry) + g_xs, needs))

    def _vjp(self, rec):
        """``rec``'s VJP at the counter: the cotangents of its carry and
        ``xs`` leaves (``None`` for a leaf that takes none)."""
        outs, gouts = [], []
        for t, g in zip(_leaves(rec.state), self.gc):
            if g is not None and t.requires_grad:
                outs.append(t)
                gouts.append(g)
        # an output that is the new carry itself (stored states): the loop
        # adds its cotangent to the carry's before the next interval's
        # parts, so it enters the next interval's VJP first, as a seed of
        # that interval's carry leaf (here only at the last interval)
        states = _leaves(rec.state)
        stored = {i: j for i, t in enumerate(_leaves(rec.y))
                  for j, u in enumerate(states) if t is u}
        k = self.bcounter
        for i, (t, g) in enumerate(zip(_leaves(rec.y), self.gys)):
            if g is not None and t.requires_grad:
                row = g.index_select(0, k)[0]
                outs.append(t)
                gouts.append(torch.where((k == self.n - 1)[0], row, 0)
                             if i in stored else row)
        for i, j in stored.items() if rec is not self.first else ():
            c, g = _leaves(rec.carry)[j], self.gys[i]
            if g is not None and c.requires_grad:
                row = g.index_select(0, (k - 1).clamp(min=0))[0]
                outs.append(c)
                gouts.append(torch.where((k > 0)[0], row, 0))
        leaves = _leaves(rec.carry) + _leaves(rec.x)
        ins = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(outs, ins, gouts, retain_graph=True,
                                       allow_unused=True)
                   if outs and ins else [None] * len(ins))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        nc = len(_leaves(rec.carry))
        return grads[:nc], grads[nc:]

    def _write_xs(self, g_xs):
        with torch.no_grad():
            for buf, g in zip(self.gxs, g_xs):
                if buf is not None:
                    row = torch.zeros_like(buf[0]) if g is None else g
                    buf.index_copy_(0, self.bcounter, row[None])

    def _vjp_interval(self):
        """One interval's VJP at the counter, from the template: the
        ``xs`` row's cotangent into the gradient of ``xs``, the carry's
        into its buffer; the counter counts down."""
        g_carry, g_xs = self._vjp(self.tpl)
        self._write_xs(g_xs)
        with torch.no_grad():
            for buf, g in zip(self.gc, g_carry):
                if buf is not None:
                    buf.zero_() if g is None else buf.copy_(g)
            self.bcounter.sub_(1)

    def recompute(self, inputs, grads):
        """The loop's forward again from the saved inputs, and its
        gradient: the backward with ``create_graph=True`` (grad mode on:
        differentiable) and where a later forward overwrote the
        stacks."""
        create = torch.is_grad_enabled()
        nc = len(self.key[0])
        with torch.enable_grad():
            if not create:
                inputs = [_leaf(t, t.requires_grad) for t in inputs]
            carry = _unflatten(self.trees[0], inputs[:nc])
            xs = _unflatten(self.trees[1], inputs[nc:])
            outs = _leaves(_loop(self.step, carry, xs, self.n))
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            ins = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], ins, [g for _, g in pairs],
                create_graph=create, allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


class _ScanVJP(torch.autograd.Function):
    """The autograd node of a :class:`_Tape`: inputs the scan's carry and
    ``xs`` leaves, outputs its final carry and ``ys`` leaves."""

    @staticmethod
    def forward(ctx, tape, *inputs):
        ctx.tape, ctx.generation = tape, tape.generation
        ctx.save_for_backward(*inputs)
        outs = [t.clone() for t in _leaves(tape.carry) + _leaves(tape.ys)]
        ctx.mark_non_differentiable(*[t for t in outs
                                      if not _differentiable(t)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        tape = ctx.tape
        if torch.is_grad_enabled() or ctx.generation != tape.generation:
            return (None,) + tape.recompute(ctx.saved_tensors, grads)
        return (None,) + tape.backward(grads, ctx.needs_input_grad[1:])


# -- jax.lax.while_loop ----------------------------------------------------

#: masked iterations of a :func:`while_loop` between two reads of its flag
#: (``tools/ode_graph_sweep.py chunks``: of 4, 8 and 16, 4 ran the graphed
#: ODE intervals fastest, host-bound and device-bound alike; an interval
#: computes up to two chunks past its end)
WHILE_CHUNK = 4

#: the host's reads of a :func:`while_loop`'s flag: by replays of a
#: captured chunk (``"graph"``) and by the eager loop (``"eager"``)
FLAG_READS = {"graph": 0, "eager": 0}


def while_loop(cond, body, state):
    """``jax.lax.while_loop`` on the port: ``state`` (a tuple of tensors
    on one device) through ``body`` while ``cond(state)`` (a 0-d bool
    tensor) holds; returns the final state.

    The loop runs in chunks of :data:`WHILE_CHUNK` masked iterations,
    ``state = where(cond(state), body(state), state)``, so that an
    iteration after the loop has ended changes nothing, bit for bit, and
    the host reads the flag once a chunk.  Eagerly (on the CPU, under
    autograd, for a mesh of more than one rank) it reads it after each
    chunk.  Inside the capture of a ``graphed(..., loop=True)`` site the
    chunk is captured once and replayed until the flag reads false
    (:class:`_Segments`): the same iterations, so the same bits."""
    state = tuple(state)
    if _Segments.active is not None:
        return _Segments.active.loop(cond, body, state)
    while True:
        state = _chunk(cond, body, state)
        FLAG_READS["eager"] += 1
        if not bool(cond(state)):
            return state


def _masked(cond, body, state):
    go = cond(state)
    return tuple(torch.where(go, new, old)
                 for new, old in zip(body(state), state))


def _chunk(cond, body, state):
    for _ in range(WHILE_CHUNK):
        state = _masked(cond, body, state)
    return state


# -- jax.jit of one call --------------------------------------------------


def graphed(body, *, mesh=None, operators=(), controls=(), own_pool=False,
            lend=False, loop=False):
    """``jax.jit`` of ``body`` on the port: a :class:`Graphed` whose
    calls on the card each replay one CUDA graph of ``body`` (two while
    autograd records: its forward and its VJP).

    ``operators`` names the parameters whose tensors the graph reads in
    place (planes, diagonals, index arrays: never copied per call);
    ``controls`` names those that change from call to call as Python
    numbers or host arrays (a Python number is written into a 0-d
    float64 (complex128) buffer on the card, a host array copied into a
    buffer of its dtype), so that a new value replays the same graph.
    Every other tensor on the card is a per-call input, copied into its
    static buffer; every other argument (host coefficient arrays used as
    kernel scalars, Python numbers, ``None``) is part of the graph's key
    by value.  ``mesh``: a mesh whose group spans more than one rank
    makes every call run ``body`` eagerly (cross-rank exchanges are not
    captured).  ``own_pool``: each capture goes into a memory pool of
    its own instead of the process's shared one, so that the blocks it
    holds (an Arnoldi basis, a step's temporaries) go back to the
    device at ``torch.cuda.empty_cache()`` once the graph is freed (a
    new key, or the site dropped with its owner).  ``lend``: a replay
    returns the graph's own output tensors, valid until the site's next
    call, instead of clones; and a key is captured at its second call,
    after ``torch.cuda.empty_cache()`` has given back what the first,
    eager call left (its outputs dropped by then), so that the site
    never holds a large output (an Arnoldi basis) twice.  ``loop``: the
    body runs a :func:`while_loop` (``jax.jit`` of a function around
    ``lax.while_loop``); its capture is cut there (:class:`_Segments`),
    a replay runs the loop's chunk until its flag reads false, and while
    autograd records the body runs eagerly (``jax.grad`` refuses a
    ``while_loop``)."""
    return Graphed(body, mesh=mesh, operators=operators, controls=controls,
                   own_pool=own_pool, lend=lend, loop=loop)


class Graphed:
    """``body`` as one replayed CUDA graph per call (:func:`graphed`).

    - The first call with a given key runs ``body`` eagerly on a side
      stream (the kernels get built and one-time device constants made)
      and returns that result; then it captures one call over static
      buffers (capturing runs nothing on the device), so that every
      call issues one call's launches.  With ``lend`` the capture waits
      for the key's second call, which then replays it.
    - A later call with the same key copies its per-call inputs into the
      static buffers, replays once and returns clones of the outputs, so
      that the next call does not overwrite a result the caller holds
      (with ``lend``, the static outputs themselves).
    - The key holds each per-call input's shape, dtype and device (not
      its strides: it is copied into its buffer), each operator tensor's
      address, shape, strides and dtype, and every other argument's
      value (host tensors and arrays by their bytes).  A call with
      another key captures anew and frees the old graph.
    - While autograd records through a per-call input or an operator
      tensor, a call is one ``torch.autograd.Function`` (:class:`_GradCall`,
      ``jax.grad`` of a ``jax.jit`` call): the first call of such a key
      runs the body and its VJP once eagerly, then two graphs are
      captured into a pool of their own, the forward keeping the tensors
      autograd saves (its residuals) where it wrote them and the VJP
      reading them there; every call replays the forward and returns
      clones of the outputs (its residuals are moved into clones only
      when a next call would overwrite them), its backward replays the
      VJP.  The key then also holds which tensors require grad.
    - ``body`` runs as it is (no graph): on the CPU, inside an enclosing
      capture or recording (a :func:`scan` over a graphed step captures
      straight through it), under a ``torch.func`` transform, and on a
      mesh whose group spans more than one rank (decided from
      ``mesh.world_size``).
    - A body (or its VJP) that reads the host raises ``RuntimeError`` at
      its capture, naming the step; it never falls back to the eager
      body.

    :attr:`captures` counts the captures, :attr:`body` is the function
    itself.  The launch counters see each replay's launches, as in
    :func:`scan`."""

    def __init__(self, body, *, mesh=None, operators=(), controls=(),
                 own_pool=False, lend=False, loop=False):
        functools.update_wrapper(self, body)
        self.body = body
        self.mesh = mesh
        self.operators = frozenset(operators)
        self.controls = frozenset(controls)
        self.own_pool = bool(own_pool)
        self.lend = bool(lend)
        self.loop = bool(loop)
        self.captures = 0
        self._params = inspect.signature(body)
        self._call = None
        self._grad = None
        self._seen = None  # with lend: the key whose first call ran

    def __call__(self, *args, **kwargs):
        bound = self._params.bind(*args, **kwargs)
        device, grad = self._route(bound.arguments)
        if device is None or (grad and self.loop):
            return self.body(*args, **kwargs)
        key, inputs = self._key(bound.arguments, device.type)
        if grad:
            return self._differentiated(key, device, bound, inputs)
        if self._call is not None and self._call.key == key:
            self._call.load(inputs)
            return self._call.replay()
        self._call = None  # its blocks go back to the pool first
        if self.lend:
            return self._lent(key, device, bound, inputs)
        out, self._call = _Call.first(self, key, device, bound, inputs)
        self.captures += 1
        return out

    def _lent(self, key, device, bound, inputs):
        """A call of a lending site with a key it has no graph of: the
        key's first call runs eagerly on the side stream; its second is
        captured, once the first's blocks are given back, and replayed."""
        if self._seen != key:
            self._seen = key
            out, _ = _first_on_side(
                self.body, device,
                lambda: (self.body(*bound.args, **bound.kwargs), None),
                "graphed")
            return out
        torch.cuda.empty_cache()
        self._call = _Call.captured(self, key, device, bound, inputs)
        self.captures += 1
        return self._call.replay()

    def _route(self, arguments):
        """The card the call runs on (``None``: run the body) and whether
        autograd records through one of its tensors."""
        if self.mesh is not None and self.mesh.world_size > 1:
            return None, False
        tensors = []
        _walk(arguments, tensors, set(), keyed=False)
        cards = [t.device for t in tensors if t.is_cuda]
        if not cards or _Saved.depth or \
                torch.cuda.is_current_stream_capturing():
            return None, False
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            return cards[0], False
        if torch._C._are_functorch_transforms_active():
            return None, False
        return cards[0], True

    def _key(self, arguments, card="cuda"):
        """The graph's key and the per-call inputs ``(name, value)``: the
        tensors on a device of type ``card`` that are no operator."""
        key, inputs = [], []
        for name, value in arguments.items():
            here = isinstance(value, torch.Tensor) \
                and value.device.type == card
            if name in self.operators and not here:
                key.append((name, _walk(value, [], set())))
            elif name in self.operators:
                key.append((name, "operator", _identity(value)))
            elif here:
                key.append((name, "input", _layout(value)))
                inputs.append((name, value))
            elif name in self.controls and _is_number(value):
                key.append((name, "number", isinstance(value, complex)))
                inputs.append((name, value))
            elif name in self.controls and _is_host_array(value):
                a = np.asarray(value)
                key.append((name, "array", a.shape, a.dtype.str))
                inputs.append((name, a))
            else:
                key.append((name, _walk(value, [], set())))
        return tuple(key), inputs

    def _differentiated(self, key, device, bound, inputs):
        """The call as an output of :class:`_GraphedVJP`, or the body
        where it closes over a tensor that requires grad.  The key
        gains which tensors require grad."""
        per_call = {name for name, value in inputs
                    if isinstance(value, torch.Tensor)}
        flags, grads = _grad_inputs(bound.arguments, per_call)
        key = key + (flags,)
        call = self._grad
        if call is None or call.key != key:
            self._grad = None  # its graphs and their pool go first
            call = self._grad = _GradCall(self.body, self._params, key,
                                          device, bound, inputs, per_call)
            self.captures += 0 if call.closes else 2
        if call.closes:
            return self.body(*bound.args, **bound.kwargs)
        return call(bound, inputs, grads)


def _grad_inputs(arguments, per_call):
    """Which tensors of a call require grad, in argument order (a
    per-call input 1 or 0; a tensor read in place 1, 2 where the same
    tensor came before: its gradient is taken once, or 0), and those the
    call is differentiated with respect to, as ``(name, tensor)``: a
    per-call input's argument name, ``None`` for a tensor read in
    place."""
    flags, grads, seen = [], [], set()
    for name, value in arguments.items():
        if name in per_call:
            flags.append(int(value.requires_grad))
            if value.requires_grad:
                grads.append((name, value))
            continue
        tensors = []
        _walk(value, tensors, set(), keyed=False)
        for t in tensors:
            flags.append(0 if not t.requires_grad else
                         2 if id(t) in seen else 1)
            if flags[-1] == 1:
                grads.append((None, t))
            seen.add(id(t))
    return tuple(flags), grads


class _GradCall:
    """One key of a :class:`Graphed` body under autograd, differentiated
    as ``jax.grad`` differentiates a ``jax.jit`` call.  The forward
    graph F records one call over the static buffers; the tensors
    autograd saves there (the call's residuals) stay where F writes
    them, held by a one-slot in-place :class:`_Saved` in a pool of F's
    own (no other graph reuses their blocks), and the graph B of its
    VJP (``torch.autograd.grad`` of F's template) reads them there.  A
    call replays F and returns clones of its outputs
    (:class:`_GraphedVJP`); the next call first moves the residuals F
    holds into clones on their call's node (as a ``jax.jit`` forward
    returns fresh residual buffers), unless its backward has run.  A
    node's backward copies its clones back where it has them and
    replays B, so that a call whose residuals a later call overwrote is
    never read: N chained calls and one backward clone and copy back
    N − 1 calls' residuals, a call and its backward none.  A second
    backward of a call whose residuals were overwritten since
    (``retain_graph=True``) reruns its body."""

    def __init__(self, body, params, key, device, bound, inputs, per_call):
        """The body and its VJP run once eagerly on the side stream (the
        kernels get built, autograd's device thread comes up), then F
        and B are captured.  The warm-up's cached blocks are released
        first: a capture that runs short of memory cannot release
        them."""
        self.body, self.params, self.key = body, params, key
        self.per_call = per_call
        self.holder = None  # weak reference to the node whose residuals
        #                     F's blocks hold
        with torch.no_grad():
            # compact buffers, copied into at every call
            self.buffers = [
                value.detach().clone(memory_format=torch.contiguous_format)
                if isinstance(value, torch.Tensor) else _buffer(value, device)
                for _, value in inputs]
        # the body's arguments over the buffers, leaves where they
        # require grad
        self.args = self.params.bind(*bound.args, **bound.kwargs)
        for (name, value), buf in zip(inputs, self.buffers):
            self.args.arguments[name] = _leaf(buf, value.requires_grad) \
                if name in self.per_call else buf
        self.ins = [t for _, t in _grad_inputs(self.args.arguments,
                                                per_call)[1]]
        self.closes = False

        def warm_up():
            with torch.enable_grad():
                out = body(*self.args.args, **self.args.kwargs)
            self.closes = _Record(self.ins, None, out, None) \
                .closes_over_grad()
            if not self.closes:
                self._vjp_of(out, [torch.zeros_like(t) for t in
                                   _leaves(out)], retain=False)
            return out, None

        out, _ = _first_on_side(body, device, warm_up, "graphed")
        if self.closes:
            return
        self.tree = _map(lambda t: True, out)
        self.signature = _signature(out)
        with torch.no_grad():
            self.gouts = [torch.zeros_like(t) if _differentiable(t) else None
                          for t in _leaves(out)]
            self.gins = [torch.zeros_like(t) for t in self.ins]
        del out
        torch.cuda.empty_cache()
        zero = torch.zeros(1, dtype=torch.int64, device=device)
        self.saved = _Saved(body, 1, zero, zero, in_place=True)
        self.tpl = None
        self.graph, _, self.delta = _captured(
            device, self._template, lambda exc: _refused(body, exc,
                                                         "graphed"),
            pool=_OWN_POOL)
        self.vjp_graph, _, self.vjp_delta = _captured(
            device, self._vjp, lambda exc: _refused(body, exc,
                                                    "graphed backward"),
            pool=self.graph.pool())

    def _template(self):
        """One call over the static buffers with autograd recording, its
        saves kept in :attr:`saved`: F's body, kept as the template of
        the VJP."""
        with torch.enable_grad(), self.saved.recording(self.buffers):
            out = self.body(*self.args.args, **self.args.kwargs)
        if _signature(out) != self.signature:
            raise ValueError(f"the output changed from {self.signature} to "
                             f"{_signature(out)}")
        self.tpl = out
        return out

    def _vjp_of(self, out, gouts, retain=True):
        """The cotangents ``gouts`` of ``out``'s leaves pulled back to
        :attr:`ins`, into :attr:`gins` where ``retain`` (B's body, over
        the template)."""
        pairs = [(t, g) for t, g in zip(_leaves(out), gouts)
                 if g is not None and t.requires_grad]
        got = torch.autograd.grad(
            [t for t, _ in pairs], self.ins, [g for _, g in pairs],
            retain_graph=retain, allow_unused=True) \
            if pairs else [None] * len(self.ins)
        if retain:
            with torch.no_grad():
                for buf, g in zip(self.gins, got):
                    buf.zero_() if g is None else buf.copy_(g)

    def _vjp(self):
        self._vjp_of(self.tpl, self.gouts)

    def __call__(self, bound, inputs, grads):
        """One call: the residuals F holds moved to their node, the
        per-call inputs loaded, F replayed; its outputs (clones) as
        outputs of :class:`_GraphedVJP`, whose inputs are the tensors
        ``grads`` (:func:`_grad_inputs`), in the body's structure."""
        self._evict()
        _load(self.buffers, inputs)
        self.graph.replay()
        _add_launches(self.delta)
        outs = _GraphedVJP.apply(self, bound, *(t for _, t in grads))
        return _unflatten(self.tree, outs)

    def _evict(self):
        """The residuals F holds into clones on their node, where it
        lives and its backward has not run."""
        ctx = self.holder and self.holder()
        self.holder = None
        if ctx is not None and not ctx.done:
            with torch.no_grad():
                ctx.residuals = [s.clone() for s in self.saved.stacks]

    def holds(self, ctx) -> bool:
        """Whether the residuals of ``ctx``'s call are still at hand."""
        return ctx.residuals is not None or (
            self.holder is not None and self.holder() is ctx)

    def backward(self, ctx, grads, needs):
        """A call's cotangents: its residuals (unless F's blocks hold
        them) and the output cotangents into the static buffers, B
        replayed."""
        with torch.no_grad():
            if ctx.residuals is not None:
                self._evict()
                for stack, r in zip(self.saved.stacks, ctx.residuals):
                    stack.copy_(r)
                ctx.residuals = None
                self.holder = weakref.ref(ctx)
            for buf, g in zip(self.gouts, grads):
                if buf is not None:
                    buf.zero_() if g is None else buf.copy_(g)
        self.vjp_graph.replay()
        _add_launches(self.vjp_delta)
        ctx.done = True
        return tuple(g.clone() if need else None
                     for g, need in zip(self.gins, needs))

    def recompute(self, bound, inputs, grads):
        """The call's body rerun under recording from its own arguments,
        and its gradient: a backward with ``create_graph=True`` (grad
        mode on; second derivatives are the body's) or of a call whose
        residuals are gone.  The per-call inputs enter the rerun as
        leaves (as views with ``create_graph``, so that second
        derivatives reach their history): its gradient with respect to
        a tensor it also reaches through an input's history (the
        coefficients of chained calls) is this call's share alone."""
        create = torch.is_grad_enabled()
        args = self.params.bind(*bound.args, **bound.kwargs)
        ins, in_place, history = [], False, False
        for (name, _), t in zip(_grad_inputs(bound.arguments,
                                             self.per_call)[1], inputs):
            if name is None:
                in_place = True
            else:
                history = history or t.grad_fn is not None
                t = t.view_as(t) if create else _leaf(t, True)
                args.arguments[name] = t
            ins.append(t)
        if create and in_place and history:
            raise RuntimeError(
                f"graphed: step {_name(self.body)}: a backward with "
                f"create_graph=True through a call whose operator tensors "
                f"require grad needs its per-call inputs to be leaves (an "
                f"operator tensor reached through an input's history would "
                f"be counted twice)")
        with torch.enable_grad():
            out = self.body(*args.args, **args.kwargs)
            pairs = [(o, g) for o, g in zip(_leaves(out), grads)
                     if o.requires_grad and g is not None]
            if not pairs:
                return (None,) * len(inputs)
            return torch.autograd.grad(
                [o for o, _ in pairs], ins, [g for _, g in pairs],
                create_graph=create, allow_unused=True)


class _GraphedVJP(torch.autograd.Function):
    """The autograd node of one :class:`Graphed` call under autograd
    (:class:`_GradCall`): inputs the tensors the call is differentiated
    with respect to, outputs clones of F's outputs.  Its call's
    residuals are F's until the next call moves them into
    :attr:`residuals`."""

    @staticmethod
    def forward(ctx, call, bound, *inputs):
        ctx.call, ctx.bound = call, bound
        ctx.save_for_backward(*inputs)
        ctx.residuals, ctx.done = None, False
        call.holder = weakref.ref(ctx)
        outs = [t.detach().clone() for t in _leaves(call.tpl)]
        ctx.mark_non_differentiable(*[t for t in outs
                                      if not _differentiable(t)])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        if call.holds(ctx) and not torch.is_grad_enabled():
            got = call.backward(ctx, grads, ctx.needs_input_grad[2:])
        else:
            got = call.recompute(ctx.bound, ctx.saved_tensors, grads)
        return (None, None) + tuple(got)


class _Call:
    """One call of a :class:`Graphed` body captured over static
    buffers."""

    def __init__(self, key, buffers, graph, out, delta, lend=False):
        self.key = key
        self.buffers = buffers   # static per-call inputs
        self.graph = graph       # a loop site's: its :class:`_Segments`
        self.out = out           # static outputs
        self.delta = delta       # launches one replay issues
        self.lend = lend         # a replay returns ``out`` itself

    @classmethod
    def first(cls, owner, key, device, bound, inputs):
        """The body run eagerly on the side stream (its result is the
        call's), then one call captured over static buffers.  Returns
        ``(result, _Call)``."""
        out, _ = _first_on_side(
            owner.body, device,
            lambda: (owner.body(*bound.args, **bound.kwargs), None),
            "graphed")
        return out, cls.captured(owner, key, device, bound, inputs)

    @classmethod
    def captured(cls, owner, key, device, bound, inputs):
        """One call captured over static buffers that hold ``inputs``
        (capturing runs nothing on the device)."""
        buffers = [_buffer(value, device) for _, value in inputs]
        for (name, _), buf in zip(inputs, buffers):
            bound.arguments[name] = buf
        capture = functools.partial(_captured, split=True) if owner.loop \
            else _captured
        graph, static, delta = capture(
            device, lambda: owner.body(*bound.args, **bound.kwargs),
            lambda exc: _refused(owner.body, exc, "graphed"),
            pool=_OWN_POOL if owner.own_pool else None)
        return cls(key, buffers, graph, static, delta, owner.lend)

    def load(self, inputs):
        _load(self.buffers, inputs)

    def replay(self):
        self.graph.replay()
        _add_launches(self.delta)
        return self.out if self.lend else _map(torch.clone, self.out)


def _load(buffers, inputs):
    """A later call's per-call inputs into the static buffers: host
    arrays through pinned memory on the card, so that no copy waits for
    the device."""
    with torch.no_grad():
        for buf, (_, value) in zip(buffers, inputs):
            if isinstance(value, torch.Tensor):
                buf.copy_(value)
            elif isinstance(value, np.ndarray):
                host = torch.from_numpy(value)
                buf.copy_(host.pin_memory() if buf.is_cuda else host,
                          non_blocking=True)
            else:
                buf.fill_(value)


def _is_number(x) -> bool:
    return isinstance(x, (int, float, complex, np.number)) \
        and not isinstance(x, (bool, np.bool_))


def _is_host_array(x) -> bool:
    return isinstance(x, np.ndarray) or (
        isinstance(x, torch.Tensor) and x.device.type == "cpu")


def _buffer(value, device) -> torch.Tensor:
    """A static buffer on ``device`` holding a per-call input."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value).to(device).clone()
    dtype = torch.complex128 if isinstance(value, complex) or np.iscomplexobj(
        value) else torch.float64
    return torch.full((), value, dtype=dtype, device=device)


def _layout(t: torch.Tensor) -> tuple:
    """A per-call input's key: its strides do not matter, since the
    graph reads the buffer it is copied into."""
    return (tuple(t.shape), t.dtype, t.device)


def _identity(t: torch.Tensor) -> tuple:
    """An operator tensor's key: the graph reads it in place."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _walk(obj, tensors, seen, keyed=True):
    """The key of ``obj``: tensors on the card by address and layout
    (each also appended to ``tensors``), host tensors, arrays and other
    values by value, containers, dataclasses and objects through their
    fields.  ``keyed=False`` only collects the tensors."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        if not keyed or obj.is_cuda:
            return _identity(obj) if keyed else None
        flat = obj.detach().contiguous().reshape(-1)
        return ("host", str(obj.dtype), tuple(obj.shape),
                flat.view(torch.uint8).numpy().tobytes())
    if not keyed and isinstance(obj, (np.ndarray, str, int, float, complex)):
        return None
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, float):
        return ("float", obj.hex())
    if isinstance(obj, complex):
        return ("complex", obj.real.hex(), obj.imag.hex())
    if obj is None or isinstance(obj, (bool, int, str, np.generic,
                                       torch.dtype, torch.device)):
        return (type(obj).__name__, repr(obj))
    if isinstance(obj, (types.FunctionType, types.MethodType,
                        types.BuiltinFunctionType)):
        # a key cannot see what a function closes over: a function is
        # equal only to itself (a method: the same function of the same
        # object), and the key holds it, so that its id is not reused
        return ("callable", obj) if keyed else None
    if id(obj) in seen:
        return ("cycle", id(obj))
    seen = seen | {id(obj)}
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(
            _walk(x, tensors, seen, keyed) for x in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _walk(v, tensors, seen, keyed))
                                 for k, v in obj.items())
    if isinstance(obj, functools.partial):
        return ("partial",) + tuple(_walk(x, tensors, seen, keyed) for x in
                                    (obj.func, obj.args, obj.keywords))
    fields = getattr(obj, "__dict__", None)
    if fields is None:
        return ("object", id(obj))
    return (type(obj).__qualname__, _walk(fields, tensors, seen, keyed))
