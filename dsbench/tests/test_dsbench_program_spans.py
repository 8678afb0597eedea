"""The readings of the program's own spans and counters
(``dsbench/program_spans.py``) on synthetic spans and events, the
stage-part readers on a synthetic ``Run``, and both cells traced at a tiny
size on the CPU with the program's tracer on."""
import math

import pytest

from dsbench import harness, program_spans as ps
from dsbench.tests._tiny import tiny_cell
from repro_torch.spans import Span

PART_READERS = ("plan_compile_ms_per_query", "plan_operands_ms_per_query",
                "solve_bind_ms_per_query", "solve_sweeps_ms_per_query",
                "solve_readback_ms_per_query", "solve_memo_ms_per_query")


def _span(name, a, b, sid, parent=None, **attrs):
    return Span(name, a, b, 1, sid, parent, attrs)


def test_share_inside_counts_only_the_named_spans():
    spans = [_span("solve.sweeps", 5, 25, 1), _span("prune", 0, 100, 2)]
    assert ps.share_inside([(0, 10), (20, 30)], spans, ("solve.sweeps",)) == 50.0
    assert ps.share_inside([(0, 10)], spans, ("solve.bind",)) == 0.0
    assert ps.share_inside([], spans, ("solve.sweeps",)) is None


@pytest.mark.parametrize("busy,want", [
    ([(10, 20)], 100.0 * 50 / 90),  # parse covers 40 ns of the 90 idle
    ([], 50.0),  # no device activity (a CPU run): the whole window is idle
])
def test_idle_unnamed_leaves_out_the_waiting_spans(busy, want):
    spans = [_span("parse", 0, 50, 1), _span("serve.request", 0, 100, 2)]
    assert ps.idle_unnamed_pct((0, 100), busy, spans) == pytest.approx(want)


def test_outside_and_parts():
    spans = [_span("solve.sweeps", 100, 200, 1), _span("solve.sweeps", 1000, 1100, 2),
             _span("solve", 0, 1200, 3), _span("solve.bind", 0, 50, 4, 3)]
    ev = [ps.Event("k", True, 150, 250, 7), ps.Event("m", True, 1500, 1600, 8),
          ps.Event("k", True, 1000, 1100, 9)]
    launches = [ps.Event("cudaLaunchKernel", False, 120, 130, 7),
                ps.Event("cudaLaunchKernel", False, 1300, 1310, 8)]
    by_name, far, shown = ps.outside(ev, spans, "solve.sweeps", launches)
    assert by_name == {"k": 50e-6, "m": 100e-6} and far == 0.4
    assert shown == [(False, 0.2), (True, 0.03)]
    assert ps.parts_pct(spans, "solve") == pytest.approx(100.0 * 250 / 1200)
    assert ps.parts_pct(spans, "plan") is None


def test_clock_offsets_pair_anchors_in_order():
    ev = [ps.Event(ps.ANCHOR, False, 120, 130), ps.Event(ps.ANCHOR, False, 1010, 1020),
          ps.Event("other", False, 0, 5)]
    got = ps.clock_offsets(ev, [(100, 140), (1015, 1030)])
    assert got == {"first": 0.02, "last": -0.005, "min": -0.005, "max": 0.02,
                   "bracketed": "1/2"}
    assert ps.clock_offsets(ev, [(100, 140)]) is None


def test_a_gap_is_named_by_the_innermost_span_across_most_of_it():
    spans = [_span("serve.batch", 0, 100, 1), _span("microbatch", 0, 90, 2, 1),
             _span("prune", 10, 80, 3, 2), _span("solve.sweeps", 60, 100, 4)]
    assert ps.name_gaps([(20, 70), (85, 100), (100, 200)], spans) == [
        ("prune", 50e-9), ("solve.sweeps", 15e-9), ("no span", 100e-9)]


def test_device_view_finds_the_window_busy_time_and_gaps():
    ev = [ps.Event("dsbench.window", False, 100, 200), ps.Event("k", True, 90, 120),
          ps.Event("m", True, 150, 160), ps.Event("late", True, 300, 310)]
    window, busy, gaps = ps.device_view(ev)
    assert window == (100, 200) and busy == [(100, 120), (150, 160)]
    assert gaps == [(160, 200), (120, 150)]
    assert ps.device_view(ev[1:]) is None


def test_replica_waits_and_counter_ratios():
    spans = [_span("serve.replica_wait", 10 + i, 10 + i + 1_000_000 * i, i)
             for i in range(1, 21)]
    spans.append(_span("serve.replica_wait", 500, 500 + 10**9, 99))  # starts after the window
    assert ps.replica_wait_p95_ms((0, 400), spans) == pytest.approx(19.05)
    assert ps.replica_wait_p95_ms((0, 5), spans) is None
    got = ps.counter_readings({"prune_triples_scanned": 300, "prune_survivors": 4,
                               "rows_solved": 16, "rows_useful": 12})
    assert got == {"prune_scanned_per_survivor": 75.0, "solve_row_fill_pct": 75.0}
    assert set(ps.counter_readings({"prune_triples_scanned": 3, "prune_survivors": 0,
                                    "rows_solved": 0}).values()) == {None}


@pytest.mark.parametrize("metric", PART_READERS)
def test_stage_part_readers_read_nothing_from_a_program_without_the_stage(metric):
    stage = metric.removesuffix("_ms_per_query").replace("_", ".", 1)
    rec = harness.Record(0, "Q1", "q", False, outcome="ok", t_done=1.0)
    run = harness.Run(cell=None, setup_s=1.0, window_s=1.0, t_end=1.0, records=[rec, rec],
                      stages={"solve": 1.0}, plan_builds=0, n_nodes=1, label_edges={},
                      systems={})
    assert harness.reader(metric)(run) is None
    run.stages[stage] = 0.5
    assert harness.reader(metric)(run) == 250.0


@pytest.mark.parametrize("name", ["lubm30.serve", "lubm30.adhoc"])
def test_tiny_traced_run_reads_the_programs_spans(name):
    line, out = ps.run(tiny_cell(name), 11, 1.5, device="cpu", log=lambda s: None)
    assert line["correct"], line["checks"]
    for key in ("prune_scanned_per_survivor", "solve_row_fill_pct", "replica_wait_ms.p95",
                "idle_unnamed_pct", "spans_per_request", "span_us_on", "span_us_off",
                "tracer_cost_pct"):
        assert out[key] is not None and math.isfinite(out[key]), (key, out[key])
    # no device on the CPU: nothing to place inside the spans
    assert out["k1_in_sweeps_pct"] is None and out["htod_in_upload_pct"] is None
    assert out["prune_scanned_per_survivor"] >= 1.0
    assert 0.0 < out["solve_row_fill_pct"] <= 100.0
    assert out["counters"]["rows_useful"] <= out["counters"]["rows_solved"]
