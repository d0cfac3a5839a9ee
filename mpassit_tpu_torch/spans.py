"""Spans and counters of one pipeline call.

``run_pipeline`` makes a ``Timings`` recorder and makes it the active one
(``recording``) for the call. Any module of the package then records into
it without a handle:

- ``span(name)``: a context manager that opens a
  ``torch.profiler.record_function(name)`` (the span a profiled run
  records, with the device work inside it) and appends a ``Span`` (name,
  parent, thread, t0, t1) to the active recorder. ``parent`` is the index
  of the enclosing open span of the same thread, None at the top. With no
  recorder active (a unit test that calls an apply directly) only the
  ``record_function`` opens;
- ``count(name, n)``: adds ``n`` to the active recorder's ``counts``.

The active recorder is a ``contextvars.ContextVar``, which a new thread
does not inherit: a thread the program starts (the streaming writer's)
takes the recorder when it is made and enters ``recording`` itself. Spans
of several threads append safely.

A span's ``t0``/``t1`` are ``time.perf_counter`` seconds, read outside its
``record_function`` (``t0`` before it opens, ``t1`` after it closes), so
its profiler event lies inside [t0, t1]. ``Timings.anchor`` pairs that
clock with the Unix clock (``time.time_ns``), which the profiler's events
are on: ``Timings.trace_us`` places a span on a Chrome trace's timeline.
No span synchronizes a device unless it is given one (``sync``): a span's
host time includes what it waits for.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import time
from typing import NamedTuple, Optional

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "mpassit_timings", default=None)


class Span(NamedTuple):
    name: str
    #: index in ``Timings.spans`` of the enclosing span of this thread
    parent: Optional[int]
    #: the thread's native id (the ``tid`` of its profiler events)
    thread: int
    t0: float
    t1: float


def _anchor() -> tuple:
    """(``time.perf_counter()`` seconds, ``time.time_ns()``) at one
    instant: of a few tries, the Unix reading that two perf_counter
    readings bracket most closely, against their midpoint (a try the
    thread was descheduled in would shift every span placed by it)."""
    best = None
    for _ in range(5):
        a = time.perf_counter()
        u = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2, u)
    return best[1:]


@dataclasses.dataclass
class Timings:
    """What one call recorded. ``stages[name]``: the seconds of every span
    of that name, summed (a child's seconds count in its parent's too);
    ``spans``: each span in the order it opened (a span still open has
    None for t0 and t1); ``counts``: the counters; ``anchor``:
    (``time.perf_counter()`` seconds, ``time.time_ns()``) at one instant,
    read when the recorder was made (``_anchor``)."""

    stages: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    anchor: tuple = dataclasses.field(default_factory=_anchor)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    _local: threading.local = dataclasses.field(
        default_factory=threading.local, repr=False, compare=False)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str) -> int:
        stack = self._stack()
        with self._lock:
            i = len(self.spans)
            self.spans.append(Span(name, stack[-1] if stack else None,
                                   threading.get_native_id(), None, None))
        stack.append(i)
        return i

    def _close(self, i: int, t0: float, t1: float) -> None:
        self._stack().pop()
        with self._lock:
            s = self.spans[i]
            self.spans[i] = s._replace(t0=t0, t1=t1)
            self.stages[s.name] = self.stages.get(s.name, 0.0) + (t1 - t0)

    def count(self, name: str, n) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def trace_us(self, t: float, base_ns: int = 0) -> float:
        """A ``time.perf_counter`` reading as the ``ts`` of a
        torch.profiler Chrome trace (Unix-clock microseconds less the
        trace's ``baseTimeNanoseconds``, ``base_ns``; 0 where the trace
        has none)."""
        return (self.anchor[1] - base_ns) / 1e3 + (t - self.anchor[0]) * 1e6


def active() -> Optional[Timings]:
    """The recorder of the call running in this context, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def recording(timings: Optional[Timings]):
    """Make ``timings`` the active recorder of this context (of this
    thread, for a thread that enters it) until the block ends."""
    token = _ACTIVE.set(timings)
    try:
        yield timings
    finally:
        _ACTIVE.reset(token)


class span:
    """``with span(name):`` a ``record_function`` span, recorded into the
    active recorder. ``sync``: a device that, if it is a CUDA device, is
    synchronized before the span ends, so that the device work queued in
    it is charged to it (the pipeline's top-level stages)."""

    __slots__ = ("name", "sync", "_rf", "_rec", "_i", "_t0")

    def __init__(self, name: str, sync=None):
        self.name, self.sync = name, sync

    def __enter__(self):
        rec = self._rec = _ACTIVE.get()
        if rec is not None:
            self._i = rec._open(self.name)
        self._rf = torch.profiler.record_function(self.name)
        self._t0 = time.perf_counter()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        self._rf.__exit__(*exc)
        t1 = time.perf_counter()
        if self._rec is not None:
            self._rec._close(self._i, self._t0, t1)
        return False


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the active recorder, if any."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.count(name, n)
