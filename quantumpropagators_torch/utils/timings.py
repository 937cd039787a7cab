"""Lightweight timing/counter instrumentation.

The reference toggles ``TimerOutputs`` ``@timeit_debug`` sections by
recompilation for zero-overhead-when-off profiling
(``src/timings.jl:31-91``).  Here, instrumentation is a module-level
switch: when disabled (default), :class:`TimingData` sections are no-ops
(a single attribute check); when enabled they record wall time and call
counts per section.  XLA fusion erases intra-kernel call boundaries, so
device-side "matvec counts" are recorded analytically by the kernels
(coefficient counts, Krylov orders) rather than by tracing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["TimingData", "enable_timings", "disable_timings", "timings_enabled"]

_ENABLED = False


def enable_timings() -> bool:
    """Globally enable collection of timing data (cf. reference
    ``QuantumPropagators.enable_timings()``)."""
    global _ENABLED
    _ENABLED = True
    return _ENABLED


def disable_timings() -> bool:
    global _ENABLED
    _ENABLED = False
    return _ENABLED


def timings_enabled() -> bool:
    return _ENABLED


class TimingData:
    """Per-propagator timing sections and counters."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.counters: dict[str, int] = {}

    def reset(self):
        self.times.clear()
        self.calls.clear()
        self.counters.clear()

    @contextmanager
    def section(self, name: str):
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def count(self, name: str, inc: int = 1):
        if _ENABLED:
            self.counters[name] = self.counters.get(name, 0) + int(inc)

    def report(self) -> str:
        lines = ["section                 calls      time [s]"]
        for name in sorted(self.times):
            lines.append(
                f"{name:<22} {self.calls[name]:>6} {self.times[name]:>12.6f}"
            )
        for name in sorted(self.counters):
            lines.append(f"{name:<22} {self.counters[name]:>6} (counter)")
        return "\n".join(lines)

    def __repr__(self):
        return f"TimingData({self.report()!r})"
