"""The port's own measurement, in one place: counters, spans and records.

Counters are always on: a named number, incremented at its site
(``count``), read with ``value`` / ``values``. The names:

  launch.<op>            the calls that launched an op's CUDA kernel
                         (``ops/kernels.py``)
  pvte.refresh           ``PVTE.gamma_mu`` calls
  fld.sor_iterations     the SOR iterations of every FLD solve
  selfgravity.rebuild    the self-gravity kernel's rebuilds in a run
  comm.bytes.<kind>      the bytes this rank put on the wire, per kind of
                         collective (``parallel/comm.py``)
  output.snapshot_bytes  the bytes of every snapshot written
  sync.<site>            the host's waits for the card on the run path
                         (``Simulation.advance_monitor`` and all it
                         calls), one name a site: ``landing`` (the step's
                         landing test), ``upload`` (a host scalar that
                         ``advance_to`` puts on the device), ``dt_stats``
                         (the interval's dt statistics), ``stop_test``
                         (whether a call cut short by ``max_steps`` hit the
                         output time), ``fld_upload``, ``fld_block``,
                         ``fld_iterations`` (FLD's first norm, its block
                         test, its iteration count), ``sg_kernel`` (a due
                         self-gravity kernel test), ``dust_rk45`` (the
                         adaptive swarm's block test), ``debug_nans``,
                         ``output.to_host`` (a writer's synchronise),
                         ``monitor.disk_radius``, ``monitor.pdivv_dt``,
                         ``monitor.time``, ``monitor.bodies``,
                         ``monitor.radius_limit`` (the monitor's reads),
                         ``comm.stage`` (a gloo copy through the host), ``particles.overflow`` (the
                         sharded swarm's dropped count). A site counts the
                         same on the CPU, where nothing waits.

Spans are on only while a ``torch.profiler`` records (the profiler's own
flag, ``torch.autograd.profiler._is_profiler_enabled``); otherwise
``span`` returns the shared no-op ``NOOP`` and a ``spanned`` function
calls straight through, at the cost of one flag test. An active span is a
``record_function`` range named ``fc:<name>``, so it sits on the
profiler's clock beside the card's kernels, with its host interval and
its parent span. A span's device time is read from the profiler's trace:
the kernels whose launch falls inside its range.

Records. ``Simulation.advance_monitor`` runs under ``root``, whose
monotonic clock it reads for ``monitor_stats["walltime"]`` on every call;
a call made under the profiler leaves a ``CallRecord`` in ``RECORDS``:
its steps, its counters' deltas and, per span name, the calls and host
seconds. Every snapshot, profiled or not, leaves a
``SnapshotRecord`` in ``SNAPSHOTS``: its bytes and host seconds, and those
of its parts ``to_host``, ``dump`` and ``flush``. Both are rings.
"""

from __future__ import annotations

import functools
import time
from collections import deque

from torch.autograd import profiler as _profiler

COUNTERS: dict[str, int | float] = {}
RECORDS: deque = deque(maxlen=1024)
SNAPSHOTS: deque = deque(maxlen=64)

_STACK: list[str] = []          # the names of the open spans, innermost last
_CURRENT: list = [None]         # the CallRecord of the profiled call open


def count(name: str, n: int | float = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def value(name: str) -> int | float:
    return COUNTERS.get(name, 0)


def values(prefix: str, names) -> dict:
    """The counters ``prefix`` + each of ``names``, keyed by the name (0
    where never counted)."""
    return {k: COUNTERS.get(prefix + k, 0) for k in names}


def reset(prefix: str = "") -> None:
    """Set the counters under ``prefix`` back to zero."""
    for k in COUNTERS:
        if k.startswith(prefix):
            COUNTERS[k] = 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("name", "parent", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _STACK[-1] if _STACK else None
        _STACK.append(self.name)
        self.range = _profiler.record_function("fc:" + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        host_s = (time.perf_counter_ns() - self.t0) / 1e9
        self.range.__exit__(exc_type, exc, tb)
        _STACK.pop()
        rec = _CURRENT[0]
        if rec is not None:
            rec.add(self.name, self.parent, host_s)
        return False


def span(name: str):
    """The span ``name``; ``NOOP`` unless a profiler records."""
    if not _profiler._is_profiler_enabled:
        return NOOP
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole function as the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

class SpanStats:
    """One span name's calls within a profiled call: their count, host
    seconds and the names of the spans they ran in."""
    __slots__ = ("calls", "host_s", "parents")

    def __init__(self):
        self.calls, self.host_s, self.parents = 0, 0.0, set()


class CallRecord:
    """One ``advance_monitor`` call made under the profiler."""

    def __init__(self):
        self.steps = 0
        self.seconds = 0.0
        self.counters: dict[str, int | float] = {}
        self.spans: dict[str, SpanStats] = {}

    def add(self, name, parent, host_s) -> None:
        st = self.spans.get(name)
        if st is None:
            st = self.spans[name] = SpanStats()
        st.parents.add(parent)
        st.calls += 1
        st.host_s += host_s


class _Root:
    """The root span ``sim.advance_monitor``: its host clock on every call,
    a ``CallRecord`` where the profiler records."""
    __slots__ = ("t0", "steps", "record", "range", "before")
    NAME = "sim.advance_monitor"

    def __init__(self):
        self.steps = 0
        self.record = None

    def __enter__(self):
        if _profiler._is_profiler_enabled and _CURRENT[0] is None:
            self.record = CallRecord()
            self.before = dict(COUNTERS)
            _CURRENT[0] = self.record
            _STACK.append(self.NAME)
            self.range = _profiler.record_function("fc:" + self.NAME)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        """Seconds since the call began, on the monotonic clock."""
        return time.perf_counter() - self.t0

    def __exit__(self, exc_type, exc, tb):
        seconds = self.elapsed()
        rec = self.record
        if rec is not None:
            self.range.__exit__(exc_type, exc, tb)
            _STACK.pop()
            _CURRENT[0] = None
            before = self.before
            rec.steps, rec.seconds = self.steps, seconds
            rec.counters = {k: v - before.get(k, 0)
                            for k, v in COUNTERS.items()
                            if v != before.get(k, 0)}
            RECORDS.append(rec)
        return False


def root() -> _Root:
    return _Root()


def window(steps: int) -> list[CallRecord] | None:
    """The newest profiled calls whose steps sum to ``steps`` (a traced
    window's), oldest first; None where no run of them does."""
    out, total = [], 0
    for rec in reversed(RECORDS):
        if total >= steps:
            break
        out.append(rec)
        total += rec.steps
    if steps <= 0 or total != steps:
        return None
    return out[::-1]


class _Part:
    __slots__ = ("snap", "name", "span", "t0")

    def __init__(self, snap, name):
        self.snap, self.name = snap, name

    def __enter__(self):
        self.span = span("output.snapshot." + self.name)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        parts = self.snap.parts
        parts[self.name] = parts.get(self.name, 0.0) \
            + time.perf_counter() - self.t0
        return self.span.__exit__(exc_type, exc, tb)


class SnapshotRecord:
    """One snapshot: ``bytes`` written, host ``seconds``, and the host
    seconds of its ``parts``."""

    def __init__(self):
        self.bytes = 0
        self.seconds = 0.0
        self.parts: dict[str, float] = {}

    def part(self, name: str) -> _Part:
        return _Part(self, name)

    def __enter__(self):
        self._span = span("output.snapshot")
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(exc_type, exc, tb)
        if exc_type is None:
            count("output.snapshot_bytes", self.bytes)
            SNAPSHOTS.append(self)
        return False


def snapshot() -> SnapshotRecord:
    return SnapshotRecord()
