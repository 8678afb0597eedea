"""Spans of the query path, on the profiler's clock.

A span is one interval of the program's work: its name, its start and end
in ns, the thread it ran on, its own id, its parent's id, and attributes
(the request ids it serves, the microbatch, the replica, bucket and row
counts).  The engine's stage seconds (``EngineMetrics.stage_seconds``) are
the always-on sums of the spans: inside a :func:`stages` block, every span
a thread ends adds its duration, under its name, to the dict the block
yields.  The span records are kept only while tracing is on::

    spans.enable()
    ...                      # serve requests
    records = spans.drain()  # the finished spans; the buffer is emptied
    spans.disable()

Each boundary is one read of :data:`clock`, :func:`time.perf_counter_ns`:
monotonic, so a stage's seconds cannot go negative when the wall clock is
stepped.  A record holds its boundaries on the profiler's clock:
``torch.profiler`` stamps its host events in Unix-epoch nanoseconds, so
:func:`enable` takes the offset between the two clocks once, and a record
adds it (:func:`epoch_ns`).  A span then falls on a profiler trace as it
is, from any thread (the profiler records its own ``record_function``
ranges only on the thread that started it).

While tracing is off a span costs its two clock reads, one flag test and
its addition to the stage sums: no record, no lock, no device
synchronisation.  Spans end at the host synchronisations the code already
has (a sweep's convergence read, a copy to the host), so a device trace can
be read against them.

Spans nest per thread: :func:`begin` opens one whose parent is the
innermost span open on its thread, and :func:`end` closes it.  Work that
crosses threads or awaits names its parent explicitly: :func:`record` takes
the ids, and :func:`inside` makes a span opened elsewhere the parent of what
a thread opens in its block, with the request ids that block serves.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Sequence

clock = time.perf_counter_ns  # one read a boundary; records map it by epoch_ns


class Span(NamedTuple):
    """One finished span."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    attrs: dict

    @property
    def seconds(self) -> float:
        """The span's duration."""
        return (self.end_ns - self.start_ns) / 1e9


_on = False
_generation = 0  # bumped by enable(): frames of an earlier generation are stale
_lock = threading.Lock()
_done: list[Span] = []  # guarded-by: _lock
_ids = itertools.count(1)
_local = threading.local()


def _clock_offset() -> int:
    """The profiler's clock (Unix-epoch ns) less :data:`clock`."""
    a = clock()
    wall = time.time_ns()
    return wall - (a + clock()) // 2


_offset = _clock_offset()


def epoch_ns(t: int) -> int:
    """A read of :data:`clock` on the profiler's clock, as records hold it."""
    return t + _offset


def enable() -> None:
    """Start keeping span records (and take the clocks' offset anew)."""
    global _on, _generation, _offset
    _offset = _clock_offset()
    _generation += 1
    _on = True


def disable() -> None:
    """Stop keeping span records; those kept stay until :func:`drain`."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether span records are kept."""
    return _on


def drain() -> list[Span]:
    """The finished spans kept so far, in the order they ended; empties the
    buffer."""
    with _lock:
        out = list(_done)
        _done.clear()
    return out


def new_id() -> int | None:
    """An id for a span recorded later with :func:`record` (one that spans
    awaits or threads); None while tracing is off."""
    return next(_ids) if _on else None


def record(name: str, start_ns: int, end_ns: int, *, id: int | None = None,
           parent: int | None = None, **attrs) -> None:
    """Keep one finished span, timed by the caller on :data:`clock`; a no-op
    while tracing is off."""
    if _on:
        _keep(Span(name, start_ns + _offset, end_ns + _offset, threading.get_ident(),
                   id if id is not None else next(_ids), parent, attrs))


def _keep(span: Span) -> None:
    with _lock:
        _done.append(span)


def _frames() -> list:
    """This thread's open frames ``[start, id, requests, generation]``,
    stale ones (left open across a :func:`disable`) dropped."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    while stack and stack[-1][3] != _generation:
        stack.pop()
    return stack


def begin() -> int:
    """Open a span on this thread and return its start.  While tracing, it
    gets an id, and its parent is the innermost span open on this thread."""
    t = clock()
    if _on:
        stack = _frames()
        requests = stack[-1][2] if stack else None
        stack.append([t, next(_ids), requests, _generation])
    return t


def _unwind(stack: list, match) -> list | None:
    """Pop the innermost frame ``match`` accepts and every frame above it
    (spans whose end an exception skipped); None when no frame matches."""
    for i in range(len(stack) - 1, -1, -1):
        if match(stack[i]):
            frame = stack[i]
            del stack[i:]
            return frame
    return None


def end(name: str, start_ns: int, **attrs) -> float:
    """Close the span :func:`begin` opened at ``start_ns`` on this thread and
    return its seconds, which a :func:`stages` block open on this thread
    adds up under ``name``; while tracing, keep its record (none for a span
    opened before tracing was on, or for one inside it whose end an
    exception skipped)."""
    t = clock()
    dt = (t - start_ns) / 1e9
    sink = getattr(_local, "sink", None)
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    if _on:
        stack = _frames()
        frame = _unwind(stack, lambda f: f[0] == start_ns)
        if frame is not None:
            parent = stack[-1][1] if stack else None
            _keep(Span(name, start_ns + _offset, t + _offset, threading.get_ident(),
                       frame[1], parent, attrs))
    return dt


@contextlib.contextmanager
def stages():
    """Within the block, the seconds of every span this thread ends are
    summed by name into the dict it yields (an inner block's spans stay in
    the inner dict)."""
    outer = getattr(_local, "sink", None)
    _local.sink = sink = {}
    try:
        yield sink
    finally:
        _local.sink = outer


@contextlib.contextmanager
def inside(span: int | None = None, requests: Sequence[int] | None = None):
    """Within the block, spans this thread opens have ``span`` (open on
    another thread, or across awaits; by default the innermost span open on
    this thread) as their parent, and :func:`requests` gives ``requests``.
    Does nothing while tracing is off."""
    if not _on:
        yield
        return
    stack = _frames()
    if span is None and stack:
        span = stack[-1][1]
    frame = [None, span, tuple(requests) if requests is not None else None, _generation]
    stack.append(frame)
    try:
        yield
    finally:
        _unwind(stack, lambda f: f is frame)


def requests() -> tuple[int, ...] | None:
    """The request ids of the innermost :func:`inside` block on this thread,
    in the order its caller gave them; None while tracing is off or
    outside any."""
    if not _on:
        return None
    stack = _frames()
    return stack[-1][2] if stack else None
