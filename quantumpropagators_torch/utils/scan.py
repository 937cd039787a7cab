"""The port's ``jax.lax.scan`` and ``jax.jit``: a loop over intervals
that runs, on the card, as one captured CUDA graph replayed once per
interval (:func:`scan`, :class:`GraphedScan`), and a function whose
every call replays one captured CUDA graph of itself (:func:`graphed`,
the counterpart of ``jax.jit(shard_map(...))`` for the sharded steps of
``parallel/``).

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
  written inside it (``index_copy_``); the graph increments the counter
  and ends by copying the new carry into the carry buffer (one read and
  one write of the carry: about 2 % of a 2^24 complex128 step);
- the graph is replayed ``length − 1`` times, with no host work per
  interval beyond the replay call.

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

On the CPU, and while autograd records, :func:`scan` is the plain loop
of the same step (the graphed backward is not ported).  Autograd
records when the carry or ``xs`` requires grad, or when the first
interval's results do: the step closes over a tensor that requires
grad.  A graph's saved tensors would be overwritten by every replay, so
such a scan finishes as the loop after its eager first interval.
:class:`GraphedScan` keeps its graph between calls: every call with
inputs of the captured shapes copies them into the static buffers and
replays, one capture for every control update.

:func:`graphed` follows the same rules for one call of a function
(:class:`Graphed`): eager first call, one capture per key (operator
tensors read in place, per-call inputs and controls copied into static
buffers), a replay and cloned outputs per later call; the body as it is
on the CPU, inside an enclosing capture, while autograd records and on a
mesh of more than one rank.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from ..ops import banded_spmv as _banded
from ..ops import cheby_flip as _flip

__all__ = ["scan", "GraphedScan", "graphed", "Graphed"]

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
    interval eagerly and ``length − 1`` replays).  A step without ``xs``
    and outputs replays for any ``length``; other shapes capture anew.
    On the CPU, or while autograd records, it is :func:`scan`.  The
    graph reads the tensors the step closes over as they were at its
    capture: one that comes to require grad later needs a new
    :class:`GraphedScan`.  The results are returned as new tensors: the
    next call overwrites the static buffers."""

    def __init__(self, step):
        self.step = step
        self._graph = None

    def __call__(self, carry, xs=None, length=None):
        out, static = self._run(carry, xs, length)
        if not static:
            return out
        return _map(torch.clone, out[0]), _map(torch.clone, out[1])

    def _run(self, carry, xs, length):
        """``(carry, ys)`` and whether they are the graph's static
        buffers."""
        n = _length(xs, length)
        if n == 0 or not _on_card(carry, xs) or _records_grad(carry, xs):
            return _loop(self.step, carry, xs, n), False
        key = (_signature(carry), _signature(xs))
        graph = self._graph
        if graph is not None and graph.key == key and (
                graph.n == n or not _leaves(graph.ys)):
            return graph.rerun(carry, xs, n), True
        self._graph = None  # its blocks go back to the pool first
        graph = _Graph(self.step, key)
        out = graph.run(carry, xs, n)
        if graph.graph is None:  # autograd recorded: the loop ran
            return out, False
        self._graph = graph
        return out, True


def _signature(tree):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in _leaves(tree))


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


def _refused(step, why, what="scan") -> str:
    name = getattr(step, "__qualname__", None) or repr(step)
    return (f"{what}: step {name} cannot be captured as a CUDA graph (a "
            f"step on the card must not read the host): {why}")


def _captured(device, fn, refused):
    """``fn()`` captured as a CUDA graph on the device's side stream into
    the shared pool (capturing runs nothing on the device).  Returns the
    graph, what ``fn`` returned and the launches one replay issues (the
    counters' delta over the capture, which is taken back).  A failed
    capture raises ``RuntimeError(refused(exc))``."""
    cur = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(cur)
    before = [dict(c) for c in _COUNTERS]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=_graph_pool(device))
            try:
                out = fn()
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    # the capture was already invalidated by exc, and the
                    # allocator still routes this stream's allocations
                    # to the pool: capture on a new stream into a new
                    # pool from now on
                    index = _index(device)
                    _SIDE_STREAMS.pop(index, None)
                    _POOLS.pop(index, None)
                raise RuntimeError(refused(exc)) from exc
            graph.capture_end()
        delta = tuple((c, k, c[k] - b[k]) for c, b in zip(_COUNTERS, before)
                      for k in c if c[k] != b[k])
    finally:
        for c, b in zip(_COUNTERS, before):
            c.update(b)
    cur.wait_stream(side)
    return graph, out, delta


def _add_launches(delta, times=1):
    for counts, key, d in delta:
        counts[key] += d * times


class _Graph:
    """One interval of ``step`` captured over its static buffers."""

    def __init__(self, step, key):
        self.step = step
        self.key = key           # the carry's and xs's shapes and dtypes
        self.graph = None        # the CUDAGraph, once captured
        self.delta = ()          # launches one replay issues
        self.n = None            # intervals of the capturing call
        self.carry = None        # static carry buffers
        self.xs = None           # static xs
        self.ys = None           # (n, ...) outputs
        self.counter = None      # (1,) int64: the interval being run
        self.first_eager = False
        self.device = None

    def run(self, carry, xs, n):
        """Interval 0 eagerly, the capture, then ``n − 1`` intervals
        replayed.  Where the first interval's results require grad, the
        loop from interval 1 instead, and nothing is captured."""
        leaves = _leaves(carry) + _leaves(xs)
        device = self.device = leaves[0].device
        for t in leaves:
            if t.device != device:
                raise ValueError(f"scan on the card needs carry and xs on "
                                 f"one device; got {t.device} and {device}")
        cur = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            carry1, y0 = self.step(carry, _map(lambda t: t[0], xs))
        cur.wait_stream(side)
        for t in _leaves(carry1) + _leaves(y0):
            if t.device != device:
                raise RuntimeError(_refused(
                    self.step, f"it returns a tensor on {t.device}"))
            t.record_stream(cur)
        if _records_grad(carry1, y0):
            # the step closes over a tensor that requires grad
            return _loop(self.step, carry1, xs, n, 1, [y0])
        self.first_eager = _signature(carry1) != _signature(carry)
        self.n = n
        self.carry = _map(torch.clone, carry1)
        self.xs = _map(torch.clone, xs)
        self.ys = _map(lambda t: t.new_empty((n,) + tuple(t.shape)), y0)
        _map(lambda buf, t: buf[0].copy_(t), self.ys, y0)
        self.counter = torch.ones(1, dtype=torch.int64, device=device)
        del carry1, y0
        self._capture()
        self._replay(n - 1)
        return self.carry, self.ys

    def rerun(self, carry, xs, n):
        """A later call: new inputs into the static buffers, then the
        replays (the first interval eagerly where its carry changes
        type)."""
        _map(lambda buf, t: buf.copy_(t), self.xs, xs)
        if self.first_eager:
            carry1, y0 = self.step(carry, _map(lambda t: t[0], xs))
            _map(lambda buf, t: buf.copy_(t), self.carry, carry1)
            _map(lambda buf, t: buf[0].copy_(t), self.ys, y0)
            self.counter.fill_(1)
            self._replay(n - 1)
        else:
            _map(lambda buf, t: buf.copy_(t), self.carry, carry)
            self.counter.fill_(0)
            self._replay(n)
        return self.carry, self.ys

    def _replay(self, times):
        for _ in range(times):
            self.graph.replay()
        _add_launches(self.delta, times)

    def _capture(self):
        """The graph of one interval from the static buffers: it selects
        its ``xs`` row and writes its outputs at the counter, increments
        it and copies its carry into the carry buffer.  Capturing runs
        nothing on the device.  Keeps the launches one replay issues."""

        def interval():
            x = _map(lambda t: t.index_select(0, self.counter)[0], self.xs)
            state, y = self.step(self.carry, x)
            if _signature(state) != _signature(self.carry):
                raise ValueError(
                    f"the carry changed from {_signature(self.carry)} to "
                    f"{_signature(state)}")
            _map(lambda buf, t: buf.index_copy_(0, self.counter, t[None]),
                 self.ys, y)
            self.counter.add_(1)
            _map(lambda buf, t: buf.copy_(t), self.carry, state)

        self.graph, _, self.delta = _captured(
            self.device, interval, lambda exc: _refused(self.step, exc))


# -- jax.jit of one call --------------------------------------------------

def graphed(body, *, mesh=None, operators=(), controls=()):
    """``jax.jit`` of ``body`` on the port: a :class:`Graphed` whose
    calls on the card each replay one CUDA graph of ``body``.

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
    captured)."""
    return Graphed(body, mesh=mesh, operators=operators, controls=controls)


class Graphed:
    """``body`` as one replayed CUDA graph per call (:func:`graphed`).

    - The first call with a given key runs ``body`` eagerly on a side
      stream (the kernels get built and one-time device constants made)
      and returns that result; then it captures one call over static
      buffers (capturing runs nothing on the device), so that every
      call issues one call's launches.
    - A later call with the same key copies its per-call inputs into the
      static buffers, replays once and returns clones of the outputs, so
      that the next call does not overwrite a result the caller holds.
    - The key holds each per-call input's shape, dtype and device (not
      its strides: it is copied into its buffer), each operator tensor's
      address, shape, strides and dtype, and every other argument's
      value (host tensors and arrays by their bytes).  A call with
      another key captures anew and frees the old graph.
    - ``body`` runs as it is (no graph): on the CPU, inside an enclosing
      capture (a :func:`scan` over a graphed step captures straight
      through it), while autograd records, and on a mesh whose group
      spans more than one rank (decided from ``mesh.world_size``).
    - A body that reads the host raises ``RuntimeError`` at its capture,
      naming the step; it never falls back to the eager body.

    :attr:`captures` counts the captures, :attr:`body` is the function
    itself.  The launch counters see each replay's launches, as in
    :func:`scan`."""

    def __init__(self, body, *, mesh=None, operators=(), controls=()):
        functools.update_wrapper(self, body)
        self.body = body
        self.mesh = mesh
        self.operators = frozenset(operators)
        self.controls = frozenset(controls)
        self.captures = 0
        self._params = inspect.signature(body)
        self._call = None

    def __call__(self, *args, **kwargs):
        bound = self._params.bind(*args, **kwargs)
        device = self._device(bound.arguments)
        if device is None:
            return self.body(*args, **kwargs)
        key, inputs = self._key(bound.arguments)
        if self._call is not None and self._call.key == key:
            self._call.load(inputs)
            return self._call.replay()
        self._call = None  # its blocks go back to the pool first
        out, self._call = _Call.first(self, key, device, bound, inputs)
        self.captures += 1
        return out

    def _device(self, arguments):
        """The card the call runs on, or ``None`` to run the body."""
        if self.mesh is not None and self.mesh.world_size > 1:
            return None
        tensors = []
        _walk(arguments, tensors, set(), keyed=False)
        cards = [t.device for t in tensors if t.device.type == "cuda"]
        if not cards or torch.cuda.is_current_stream_capturing():
            return None
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return None
        return cards[0]

    def _key(self, arguments):
        """The graph's key and the per-call inputs ``(name, value)``."""
        key, inputs = [], []
        for name, value in arguments.items():
            on_card = isinstance(value, torch.Tensor) \
                and value.device.type == "cuda"
            if name in self.operators and not on_card:
                key.append((name, _walk(value, [], set())))
            elif name in self.operators:
                key.append((name, "operator", _identity(value)))
            elif on_card:
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


class _Call:
    """One call of a :class:`Graphed` body captured over static
    buffers."""

    def __init__(self, key, buffers, graph, out, delta):
        self.key = key
        self.buffers = buffers   # static per-call inputs
        self.graph = graph
        self.out = out           # static outputs
        self.delta = delta       # launches one replay issues

    @classmethod
    def first(cls, owner, key, device, bound, inputs):
        """The body run eagerly on the side stream (its result is the
        call's), then one call captured over static buffers.  Returns
        ``(result, _Call)``."""
        cur = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = owner.body(*bound.args, **bound.kwargs)
        cur.wait_stream(side)
        for t in _leaves(out):
            if t.device != device:
                raise RuntimeError(_refused(
                    owner.body, f"it returns a tensor on {t.device}",
                    "graphed"))
            t.record_stream(cur)
        buffers = [_buffer(value, device) for _, value in inputs]
        for (name, _), buf in zip(inputs, buffers):
            bound.arguments[name] = buf
        graph, static, delta = _captured(
            device, lambda: owner.body(*bound.args, **bound.kwargs),
            lambda exc: _refused(owner.body, exc, "graphed"))
        return out, cls(key, buffers, graph, static, delta)

    def load(self, inputs):
        """A later call's per-call inputs into the static buffers: host
        arrays through pinned memory, so that no copy waits for the
        device."""
        for buf, (_, value) in zip(self.buffers, inputs):
            if isinstance(value, torch.Tensor):
                buf.copy_(value)
            elif isinstance(value, np.ndarray):
                buf.copy_(torch.from_numpy(value).pin_memory(),
                          non_blocking=True)
            else:
                buf.fill_(value)

    def replay(self):
        self.graph.replay()
        _add_launches(self.delta)
        return _map(torch.clone, self.out)


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
        if not keyed or obj.device.type == "cuda":
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
    if id(obj) in seen:
        return ("cycle", id(obj))
    seen = seen | {id(obj)}
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(
            _walk(x, tensors, seen, keyed) for x in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _walk(v, tensors, seen, keyed))
                                 for k, v in obj.items())
    fields = getattr(obj, "__dict__", None)
    if fields is None:
        return ("object", id(obj))
    return (type(obj).__qualname__, _walk(fields, tensors, seen, keyed))
