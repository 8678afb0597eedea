"""The traced run: host spans around the calls into each layer, and the
reduction of the profiler's device events to busy time, kernel time and
idle gaps.

The spans wrap the program's layer entry points from outside (the program
carries no spans of its own yet): the front end (``Engine.prepare``), plan
lookup and build (``Engine.plan_for``), the fixpoint with its copy back
(``CompiledPlan.execute``), pruning (``pruning.prune_triples``) and the
bindings (``soi.collect``).  Spans are taken on the host clock in every
thread (the profiler records CPU ranges only on the thread that started
it), and placed on the profiler's clock by the window's own range, which
the main thread opens at a known host time.  Only a ``--trace 1`` run
installs them.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time

WINDOW = "dsbench.window"


class Spans:
    """Host spans ``(layer, start_ns, end_ns)`` on ``time.perf_counter_ns``."""

    def __init__(self):
        self.spans: list[tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def wrap_layers(self) -> None:
        """Wrap each layer's entry point in a span, for this process."""
        from repro_torch.core import pruning, soi
        from repro_torch.engine import engine, plan

        def ranged(name, fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                t0 = time.perf_counter_ns()
                try:
                    return fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter_ns()
                    with self._lock:
                        self.spans.append((name, t0, t1))
            return inner

        engine.Engine.prepare = ranged("parse", engine.Engine.prepare)
        engine.Engine.plan_for = ranged("plan", engine.Engine.plan_for)
        plan.CompiledPlan.execute = ranged("solve", plan.CompiledPlan.execute)
        pruning.prune_triples = ranged("prune", pruning.prune_triples)
        soi.collect = ranged("collect", soi.collect)


@dataclasses.dataclass
class Summary:
    """What a trace says about the window."""

    window_s: float
    busy_s: float  # union of device activity
    device_s: dict[str, float]  # device seconds by kernel or copy name
    idle_gaps: list[tuple[str, float]]  # longest gaps, by the host range under them


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events, spans: Spans, mark_ns: int, top: int = 10) -> Summary | None:
    """Reduce raw profiler events (``prof.profiler.kineto_results.events()``)
    to a :class:`Summary` over the ``dsbench.window`` range, whose start the
    host clock read as ``mark_ns``; None when the window range is missing."""
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        return None
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    shift = w0 - mark_ns
    host = [(name, a + shift, b + shift) for name, a, b in spans.spans]
    dev = []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        a, b = max(s, w0), min(s + d, w1)
        if b > a and str(e.device_type()).endswith("CUDA"):
            dev.append((e.name(), a, b))
    device_s: dict[str, float] = {}
    for name, a, b in dev:
        device_s[name] = device_s.get(name, 0.0) + (b - a) / 1e9
    busy = _union([(a, b) for _, a, b in dev])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        # the host range covering most of the gap says what the host was doing
        best, cover = "none of the ranged layers", 0
        for name, s, e in host:
            c = min(b, e) - max(a, s)
            if c > cover:
                best, cover = name, c
        named.append((best, (b - a) / 1e9))
    return Summary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        device_s=device_s,
        idle_gaps=named,
    )
