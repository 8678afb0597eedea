"""The program's own spans and counters beside a traced run's device events.

``repro_torch.spans`` times the query path from inside: request ids from
``AsyncServer`` to pruning, the plan and the solve split into their parts,
on the profiler's clock; the engines count pruning's scans and the
fixpoint's rows (``EngineMetrics``).  The harness reads neither yet.  This
module holds the readings, and its command runs one cell traced, with the
program's tracer on, and prints the cell's log, the readings
(``program <name>: <value>``) and the result line last.  The harness's own
functions are wrapped in this process to take the profiler's events, the
counters and clock anchors, as ``dsbench/harness.py`` offers no hook:

    python3 dsbench/program_spans.py --workload <name> --seed <n> --seconds <s> [--out <file>]

Readings (each ``None`` where there is nothing to read):

* ``prune_scanned_per_survivor``: triples whose membership pruning
  evaluated over the triples it kept;
* ``solve_row_fill_pct``: 100 x the fixpoint's rows of distinct constant
  sets over the rows it solved (bucket x variables);
* ``replica_wait_ms.p95``: of the ``serve.replica_wait`` spans (executor
  call to the replica's lock) that start in the window;
* ``idle_unnamed_pct``: the share of the window's device-idle time under no
  span of work on any thread (the spans a request waits in across awaits,
  ``serve.request`` and ``serve.batch``, are not work); on
  a CPU run the whole window counts as idle;
* ``k1_in_sweeps_pct``: K1's device time inside ``solve.sweeps`` spans;
* ``dtoh_in_solve_pct`` / ``htod_in_upload_pct``: ``Memcpy DtoH`` time inside
  ``solve.sweeps`` or ``solve.readback`` spans, and ``Memcpy HtoD`` time inside
  ``plan.operands``, ``solve.bind`` or ``solve.sweeps`` spans;
* ``k1_outside_sweeps_ms``: K1's device time outside ``solve.sweeps``
  spans, by kernel, with how far the farthest such kernel lies from the
  nearest ``solve.sweeps`` span (``k1_outside_farthest_us``) and, for the
  farthest five, their launches (``k1_outside_launches``: whether the
  launch call lies inside a ``solve.sweeps`` span, and the µs from its
  start to the kernel's);
* ``plan_parts_pct`` / ``solve_parts_pct`` / ``prune_parts_pct``: the spans'
  own split, each stage's parts over the stage, in the window;
* ``idle_gaps``: the longest device-idle gaps, each named by the innermost
  span open across most of it;
* ``clock_offset_us``: the spans' clock against the profiler's, from an
  anchor range the event loop's thread opens once a second between two
  reads of the spans' clock: the range's start less the first read, at the
  first anchor, the last, and its least and greatest, and how many anchors
  the two reads bracket;
* ``spans_per_request``, ``span_us_on`` / ``span_us_off`` (a loop of 10^5
  spans with tracing on and off) and ``tracer_cost_pct``: the first two's
  product over a request's stage seconds.
"""
from __future__ import annotations

import asyncio
import bisect
import dataclasses
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # as run.py: the checkout's root and sources first
    _ROOT = Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

from dsbench import traced  # noqa: E402
from dsbench.yardstick import SEGOR_KERNELS, percentile  # noqa: E402

ANCHOR = "dsbench.anchor"
WAIT_SPANS = ("serve.request", "serve.batch")
STAGES = ("parse", "plan", "solve", "prune")
COUNTERS = ("prune_triples_scanned", "prune_survivors", "rows_solved", "rows_useful")
COST_LOOP = 100_000


@dataclasses.dataclass(frozen=True)
class Event:
    """A profiler event: its name, whether the device ran it, and its
    interval in ns on the profiler's clock."""

    name: str
    device: bool
    start: int
    end: int
    corr: int = 0  # links a kernel to its launch call


def events_of(raw) -> list[Event]:
    """``prof.profiler.kineto_results.events()`` as :class:`Event` s."""
    return [Event(e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns(),
                  e.start_ns() + e.duration_ns(), e.correlation_id()) for e in raw]


def _covered(a: int, b: int, union: list[tuple[int, int]], starts: list[int]) -> int:
    """ns of ``[a, b)`` inside ``union`` (sorted, disjoint; ``starts`` its
    starts)."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    got = 0
    while i < len(union) and union[i][0] < b:
        got += max(0, min(b, union[i][1]) - max(a, union[i][0]))
        i += 1
    return got


def share_inside(intervals: list[tuple[int, int]], spans, names) -> float | None:
    """100 x the time of ``intervals`` inside the spans named in ``names``,
    over their whole time; None without any."""
    total = sum(b - a for a, b in intervals)
    if total <= 0:
        return None
    union = traced._union([(s.start_ns, s.end_ns) for s in spans if s.name in names])
    starts = [a for a, _ in union]
    return 100.0 * sum(_covered(a, b, union, starts) for a, b in intervals) / total


def _depths(spans) -> dict[int, int]:
    parent = {s.id: s.parent for s in spans}
    depth: dict[int, int] = {}
    for sid in parent:
        chain, d = [], None
        while sid is not None and d is None:
            d = depth.get(sid)
            if d is None:
                chain.append(sid)
                sid = parent.get(sid)
        d = -1 if d is None else d
        for c in reversed(chain):
            d += 1
            depth[c] = d
    return depth


def name_gaps(gaps: list[tuple[int, int]], spans) -> list[tuple[str, float]]:
    """Each gap's name: the innermost span open across most of it, on any
    thread (the deepest in its tree; then the one covering more of the gap,
    then the shorter), else ``"no span"``; with the gap's seconds."""
    depth = _depths(spans)
    out = []
    for a, b in gaps:
        best, key = "no span", None
        for s in spans:
            cover = min(b, s.end_ns) - max(a, s.start_ns)
            rank = (depth[s.id], cover, s.start_ns - s.end_ns)
            if 2 * cover > b - a and (key is None or rank > key):
                best, key = s.name, rank
        out.append((best, (b - a) / 1e9))
    return out


def device_view(events: list[Event], top: int = 10):
    """The window (from the harness's range), the union of device activity
    inside it, and its longest idle gaps; None without the window's range."""
    win = [e for e in events if e.name == traced.WINDOW and not e.device]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    busy = traced._union([(max(e.start, w0), min(e.end, w1)) for e in events
                          if e.device and min(e.end, w1) > max(e.start, w0)])
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    return (w0, w1), busy, gaps[:top]


def idle_unnamed_pct(window: tuple[int, int], busy, spans) -> float | None:
    """100 x the device-idle time of ``window`` under no span of work, over
    the device-idle time."""
    w0, w1 = window
    idle = (w1 - w0) - sum(b - a for a, b in busy)
    if idle <= 0:
        return None
    work = traced._union([(max(s.start_ns, w0), min(s.end_ns, w1)) for s in spans
                          if s.name not in WAIT_SPANS and min(s.end_ns, w1) > max(s.start_ns, w0)])
    starts = [a for a, _ in busy]
    # work time that falls where the device was idle
    named = sum((b - a) - _covered(a, b, busy, starts) for a, b in work)
    return 100.0 * (idle - named) / idle


def replica_wait_p95_ms(window: tuple[int, int], spans) -> float | None:
    """The 95th percentile of the ``serve.replica_wait`` spans starting in
    ``window``, in ms."""
    waits = [s.seconds * 1e3 for s in spans
             if s.name == "serve.replica_wait" and window[0] <= s.start_ns < window[1]]
    return percentile(waits, 95) if waits else None


def counter_readings(counters: dict[str, int]) -> dict[str, float | None]:
    """The two ratios of the engines' counters over the window."""
    scanned, kept = counters.get("prune_triples_scanned"), counters.get("prune_survivors")
    solved, useful = counters.get("rows_solved"), counters.get("rows_useful")
    return {
        "prune_scanned_per_survivor": scanned / kept if scanned is not None and kept else None,
        "solve_row_fill_pct": 100.0 * useful / solved if useful is not None and solved else None,
    }


def span_cost_us(spans_mod, on: bool, n: int = COST_LOOP) -> float:
    """µs a nested span takes (its :func:`begin` and :func:`end`), from a loop
    of ``n``, with tracing on or off; the records are drained after."""
    was = spans_mod.enabled()
    (spans_mod.enable if on else spans_mod.disable)()
    t0 = time.perf_counter()
    for _ in range(n):
        spans_mod.end("cost", spans_mod.begin())
    dt = time.perf_counter() - t0
    (spans_mod.enable if was else spans_mod.disable)()
    if on:
        spans_mod.drain()
    return dt / n * 1e6


PARTS = {"plan": ("plan.compile", "plan.operands"),
         "solve": ("solve.bind", "solve.sweeps", "solve.readback", "solve.memo"),
         "prune": ("prune.triples", "prune.collect")}


def parts_pct(spans, stage: str) -> float | None:
    """100 x the seconds of ``stage``'s parts over its own seconds (for
    ``plan``, over the plans built: a cached plan has no parts)."""
    whole = sum(s.seconds for s in spans if s.name == stage and not s.attrs.get("hit"))
    part = sum(s.seconds for s in spans if s.name in PARTS[stage])
    return 100.0 * part / whole if whole > 0 else None


def outside(events: list[Event], spans, name: str, launches: list[Event] = ()):
    """The device time of ``events`` outside every span called ``name``, in
    ms by event name; the farthest such event's distance from the nearest of
    those spans, in µs; and for the five farthest, whether their launch call
    (the event of ``launches`` with the same correlation id) lies inside
    such a span, and the µs from the launch's start to the event's."""
    union = traced._union([(s.start_ns, s.end_ns) for s in spans if s.name == name])
    starts = [a for a, _ in union]
    by_corr = {e.corr: e for e in launches}
    by_name: dict[str, float] = {}
    far = []
    for e in events:
        out = (e.end - e.start) - _covered(e.start, e.end, union, starts)
        if out <= 0:
            continue
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + out / 1e6
        near = min((max(a - e.end, e.start - b, 0) for a, b in union), default=0)
        far.append((near / 1e3, e))
    far.sort(key=lambda x: -x[0])
    shown = []
    for _, e in far[:5]:
        la = by_corr.get(e.corr)
        shown.append(None if la is None else (
            _covered(la.start, la.end, union, starts) == la.end - la.start,
            (e.start - la.start) / 1e3))
    return by_name, (far[0][0] if far else 0.0), shown


def clock_offsets(events: list[Event], anchors: list[tuple[int, int]]) -> dict | None:
    """The anchor ranges' starts less the spans' clock read before each,
    in µs, and how many anchors the reads around them bracket."""
    starts = sorted((e.start, e.end) for e in events if e.name == ANCHOR)
    if not starts or len(starts) != len(anchors):
        return None
    off = [(a - t0) / 1e3 for (a, _), (t0, _) in zip(starts, anchors)]
    inside = sum(t0 <= a <= b <= t1 for (a, b), (t0, t1) in zip(starts, anchors))
    return {"first": off[0], "last": off[-1], "min": min(off), "max": max(off),
            "bracketed": f"{inside}/{len(off)}"}


def readings(events: list[Event], program, counters: dict[str, int],
             n_answered: int) -> dict:
    """Every reading of the module docstring but the tracer's loop cost."""
    out: dict = counter_readings(counters)
    view = device_view(events)
    if view is None:
        return out
    window, busy, gaps = view
    inside = [s for s in program if s.end_ns > window[0] and s.start_ns < window[1]]
    out["replica_wait_ms.p95"] = replica_wait_p95_ms(window, inside)
    out["idle_unnamed_pct"] = idle_unnamed_pct(window, busy, inside)
    dev = [e for e in events if e.device and window[0] <= e.start < window[1]]
    k1_events = [e for e in dev if any(k in e.name for k in SEGOR_KERNELS)]
    k1 = [(e.start, e.end) for e in k1_events]
    dtoh = [(e.start, e.end) for e in dev if e.name.startswith("Memcpy DtoH")]
    htod = [(e.start, e.end) for e in dev if e.name.startswith("Memcpy HtoD")]
    out["k1_in_sweeps_pct"] = share_inside(k1, inside, ("solve.sweeps",))
    out["dtoh_in_solve_pct"] = share_inside(dtoh, inside, ("solve.sweeps", "solve.readback"))
    out["htod_in_upload_pct"] = share_inside(
        htod, inside, ("plan.operands", "solve.bind", "solve.sweeps"))
    launches = [e for e in events if not e.device and "Launch" in e.name]
    (out["k1_outside_sweeps_ms"], out["k1_outside_farthest_us"],
     out["k1_outside_launches"]) = outside(k1_events, inside, "solve.sweeps", launches)
    for stage in PARTS:
        out[f"{stage}_parts_pct"] = parts_pct(inside, stage)
    out["idle_gaps"] = name_gaps(gaps, inside)
    out["spans_per_request"] = len(inside) / n_answered if n_answered else None
    return out


def run(cell, seed: int, seconds: float, *, device: str = "cuda", log=print):
    """Run ``cell`` once traced, with the program's tracer on: returns the
    harness's result line and the readings."""
    from dsbench import harness
    from repro_torch import spans as spans_mod

    got: dict = {"counters": [], "anchors": []}
    summarize, totals, drive = traced.summarize, harness._engine_totals, harness._drive

    def keep_events(raw, outside, mark_ns):
        raw = list(raw)
        got["events"] = events_of(raw)
        return summarize(raw, outside, mark_ns)

    def keep_counters(server, db):
        got["counters"].append(_counters(server, db))
        return totals(server, db)

    async def anchor():
        from torch.profiler import record_function

        while True:
            t0 = spans_mod.clock()
            with record_function(ANCHOR):
                pass
            got["anchors"].append((spans_mod.epoch_ns(t0), spans_mod.epoch_ns(spans_mod.clock())))
            await asyncio.sleep(1.0)

    async def drive_anchored(*args, **kwargs):
        task = asyncio.get_running_loop().create_task(anchor())
        try:
            return await drive(*args, **kwargs)
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    traced.summarize, harness._engine_totals = keep_events, keep_counters
    harness._drive = drive_anchored
    spans_mod.drain()
    spans_mod.enable()
    try:
        line, _ = harness.run_cell(cell, seed, seconds, True, device=device, log=log)
    finally:
        spans_mod.disable()
        traced.summarize, harness._engine_totals, harness._drive = summarize, totals, drive
    program = spans_mod.drain()
    before, after = got["counters"]
    counters = {k: after[k] - before[k] for k in COUNTERS}
    out = readings(got.get("events", []), program, counters,
                   line["attempted"] - line["failed"])  # the answered requests
    out["counters"] = counters
    out["clock_offset_us"] = clock_offsets(got.get("events", []), got["anchors"])
    out["stage_ms_per_request"] = sum(line["metrics"].get(f"{k}_ms_per_query", {}).get("value", 0.0)
                                      for k in STAGES)
    out["span_us_on"] = span_cost_us(spans_mod, True)
    out["span_us_off"] = span_cost_us(spans_mod, False)
    if out.get("spans_per_request") and out.get("stage_ms_per_request"):
        out["tracer_cost_pct"] = (100.0 * out["spans_per_request"] * out["span_us_on"] / 1e3
                                  / out["stage_ms_per_request"])
    return line, out


def _counters(server, db) -> dict[str, int]:
    """The four counters summed over the front end's engine and every
    replica; zeros from a program without them."""
    tot = dict.fromkeys(COUNTERS, 0)
    for m in [db.stats(), *server.router.stats()]:
        for k in COUNTERS:
            tot[k] += getattr(m, k, 0)
    return tot


def main() -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the line and the readings here, as JSON")
    args = ap.parse_args()

    import torch

    from dsbench import harness

    if not torch.cuda.is_available():
        print("program_spans: no card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    line, out = run(cell, args.seed, args.seconds, log=lambda s: print(s, flush=True))
    for k, v in out.items():
        print(f"program {k}: {v}", flush=True)
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"line": line, "readings": out}, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
