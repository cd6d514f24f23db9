"""Spans and counters inside the program, recorded only under a profiler.

    with obs.span("fluid.route"):
        ...
    obs.count("fluid.syncs")

While a ``torch.profiler`` is active, each span is a range of its name on
the profiler's timeline, beside the device's work (torch's
``_RecordFunctionFast`` where torch has it, else ``record_function``), and
its wall time is added to an in-memory table keyed by ``(name, parent)``,
the parent being the enclosing span of the same thread (``None`` at the
top).  A row keeps the calls, the total nanoseconds and the self
nanoseconds.  Recording costs the host microseconds a span, so the table
leaves that cost out: a span's total is its wall time less the recording
of the spans and counts inside it, and its self time is its wall time
less the whole cost of its direct child spans and counts, so that
``self == total - sum(direct children's totals)``.  A counter adds ``n``
to the ``count`` of its row.

While no profiler is active, ``span`` returns one shared no-op context
manager and ``count`` returns at once: the check is one read of
``torch.autograd.profiler._is_profiler_enabled``, which ``recording()``
reads for a caller whose count costs work of its own.  The module imports no
torch (the packet path's spawn workers load none); with torch not loaded,
no profiler can be active.

The table sums everything recorded in the process since the last
``reset()``: a profiler started after set-up covers exactly its window.
"""
from __future__ import annotations

import sys
import threading
from time import perf_counter_ns

_PROFILER = "torch.autograd.profiler"

_table: dict[tuple[str, str | None], dict[str, int]] = {}
_lock = threading.Lock()          # the table's updates, from any thread
_local = threading.local()        # each thread's open spans
_recorder = None                  # the profiler's range, found at the first span


class _Noop:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(name: str):
    """A profiler range named ``name``: the cheap C++ one where torch has it."""
    global _recorder
    if _recorder is None:
        torch = sys.modules["torch"]
        _recorder = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
                     or torch.autograd.profiler.record_function)
    return _recorder(name)


class _Span:
    # a: the clock as the span was asked for; t0: as its timed body starts;
    # child_ns: the whole cost of its direct children and counts; rec_ns:
    # the recording cost of everything inside it
    __slots__ = ("name", "parent", "rf", "a", "t0", "child_ns", "rec_ns")

    def __init__(self, name: str, a: int) -> None:
        self.name, self.a = name, a

    def __enter__(self) -> None:
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.child_ns = self.rec_ns = 0
        self.rf = _record(self.name)
        self.rf.__enter__()
        self.t0 = perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        dt = perf_counter_ns() - self.t0
        self.rf.__exit__(*exc)
        stack = _stack()
        stack.pop()
        with _lock:
            row = _table.get((self.name, self.parent))
            if row is None:
                row = _table[(self.name, self.parent)] = {"calls": 0, "total_ns": 0,
                                                          "self_ns": 0}
            row["calls"] += 1
            row["total_ns"] += dt - self.rec_ns
            row["self_ns"] += dt - self.child_ns
        if stack:
            whole = perf_counter_ns() - self.a
            up = stack[-1]
            up.child_ns += whole
            up.rec_ns += whole - dt + self.rec_ns
        return False


def recording() -> bool:
    """Whether spans and counters record now: a profiler is active."""
    mod = sys.modules.get(_PROFILER)
    return mod is not None and bool(mod._is_profiler_enabled)


def span(name: str):
    """A context manager timing ``name`` while a profiler records."""
    mod = sys.modules.get(_PROFILER)
    if mod is None or not mod._is_profiler_enabled:
        return NOOP
    return _Span(name, perf_counter_ns())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    mod = sys.modules.get(_PROFILER)
    if mod is None or not mod._is_profiler_enabled:
        return
    a = perf_counter_ns()
    stack = _stack()
    up = stack[-1] if stack else None
    key = (name, up.name if up else None)
    with _lock:
        row = _table.get(key)
        if row is None:
            row = _table[key] = {"count": 0}
        row["count"] += n
    if up is not None:
        cost = perf_counter_ns() - a
        up.child_ns += cost
        up.rec_ns += cost


def table() -> dict[tuple[str, str | None], dict[str, int]]:
    """A copy of the table: ``(name, parent)`` to ``{"calls", "total_ns",
    "self_ns"}`` for a span and ``{"count"}`` for a counter."""
    with _lock:
        return {k: dict(v) for k, v in _table.items()}


def reset() -> None:
    """Empty the table."""
    with _lock:
        _table.clear()
