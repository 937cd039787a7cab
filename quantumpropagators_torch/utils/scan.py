"""The port's ``jax.lax.scan``: a loop over intervals that runs, on the
card, as one captured CUDA graph replayed once per interval.

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
"""

from __future__ import annotations

import torch

from ..ops import banded_spmv as _banded
from ..ops import cheby_flip as _flip

__all__ = ["scan", "GraphedScan"]

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


def _refused(step, why) -> str:
    name = getattr(step, "__qualname__", None) or repr(step)
    return (f"scan: step {name} cannot be captured as a CUDA graph (a step "
            f"on the card must not read the host): {why}")


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
            for counts, key, d in self.delta:
                counts[key] += d

    def _capture(self):
        """The graph of one interval from the static buffers: it selects
        its ``xs`` row and writes its outputs at the counter, increments
        it and copies its carry into the carry buffer.  Capturing runs
        nothing on the device.  Keeps the launches one replay issues."""
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        before = [dict(c) for c in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=_graph_pool(self.device))
            try:
                x = _map(lambda t: t.index_select(0, self.counter)[0],
                         self.xs)
                state, y = self.step(self.carry, x)
                if _signature(state) != _signature(self.carry):
                    raise ValueError(
                        f"the carry changed from {_signature(self.carry)} "
                        f"to {_signature(state)}")
                _map(lambda buf, t: buf.index_copy_(0, self.counter, t[None]),
                     self.ys, y)
                self.counter.add_(1)
                _map(lambda buf, t: buf.copy_(t), self.carry, state)
                del state, y, x
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    # the capture was already invalidated by exc, and the
                    # allocator still routes this stream's allocations
                    # to the pool: capture on a new stream into a new
                    # pool from now on
                    index = _index(self.device)
                    _SIDE_STREAMS.pop(index, None)
                    _POOLS.pop(index, None)
                for c, b in zip(_COUNTERS, before):
                    c.update(b)
                raise RuntimeError(_refused(self.step, exc)) from exc
            graph.capture_end()
        cur.wait_stream(side)
        self.delta = tuple((c, k, c[k] - b[k])
                           for c, b in zip(_COUNTERS, before)
                           for k in c if c[k] != b[k])
        for c, b in zip(_COUNTERS, before):
            c.update(b)
        self.graph = graph
