"""The port's spans and counters (``repro_torch.spans``, ``EngineMetrics``):
the span tree of requests served through a two-replica ``AsyncServer``, the
engine's stages as the sums of their spans, the pruning and row counters,
tracing off, and the clock shared with ``torch.profiler``.  The one
``gpu``-marked case checks on the card that a solve's K1 kernels run inside
its ``solve.sweeps`` span; it skips without a card.  The file imports
neither JAX nor the JAX package."""
import asyncio
import time

import pytest
import torch

from repro_torch import spans
from repro_torch.core import pruning
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.serve import AsyncServer

MEMBERS_OF = "{{ ?d subOrganizationOf {uni} . ?s memberOf ?d }}"
WORKS_FOR = "{{ ?p worksFor ?d . ?d subOrganizationOf {uni} }}"
STAGES = ("parse", "plan", "plan.compile", "plan.operands", "solve", "solve.bind",
          "solve.sweeps", "solve.readback", "solve.memo", "prune", "prune.triples",
          "prune.collect")
PARTS = {"plan": ("plan.compile", "plan.operands"),
         "solve": ("solve.bind", "solve.sweeps", "solve.readback", "solve.memo"),
         "prune": ("prune.triples", "prune.collect")}
COUNTERS = ("prune_triples_scanned", "prune_survivors", "prune_edges_by_subject",
            "prune_edges_by_object", "prune_edges_by_label", "rows_solved", "rows_useful")
SIDES = ("prune_edges_by_subject", "prune_edges_by_object", "prune_edges_by_label")


@pytest.fixture()
def db():
    return GraphDB(synth.lubm_like(n_universities=2, seed=0), device="cpu")


@pytest.fixture()
def tracing():
    spans.drain()
    spans.enable()
    yield
    spans.disable()
    spans.drain()


def _serve(db, texts):
    async def go():
        # a pinned watchdog: a retried attempt would add a second serve.batch
        async with AsyncServer(db, replicas=2, max_batch=4, max_delay_ms=5.0,
                               default_deadline_ms=60_000.0,
                               watchdog_budget_ms=60_000.0) as server:
            return await asyncio.gather(*[server.submit(t) for t in texts])
    return asyncio.run(go())


def _texts():
    return [(MEMBERS_OF if i % 2 else WORKS_FOR).format(uni=f"Univ{i % 3 % 2}")
            for i in range(10)]


def test_span_tree_of_served_requests(db, tracing):
    results = _serve(db, _texts())
    assert all(r.ok for r in results)
    got = spans.drain()
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    for s in got:
        assert s.end_ns >= s.start_ns, s
        assert s.parent is None or s.parent in by_id, s
    names = [s.name for s in got]
    assert names.count("serve.request") == names.count("parse") == len(results)
    assert {by_id[s.parent].name for s in got if s.name == "parse"} == {"serve.request"}
    batches = [s for s in got if s.name == "serve.batch"]
    assert {s.attrs["replica"] for s in batches} <= {"r0", "r1"}
    assert sorted(r for b in batches for r in b.attrs["requests"]) == list(
        range(1, len(results) + 1))
    for wait in (s for s in got if s.name == "serve.replica_wait"):
        assert by_id[wait.parent].name == "serve.batch"
    triples = [s for s in got if s.name == "prune.triples"]
    assert triples
    for s in triples:
        up = s
        while up.name != "serve.batch":
            up = by_id[up.parent]
        assert set(s.attrs["requests"]) <= set(up.attrs["requests"]), (s, up)
    for s in got:
        if s.name == "microbatch":
            assert by_id[s.parent].name == "serve.batch"
            assert set(s.attrs["requests"]) <= set(by_id[s.parent].attrs["requests"])
    # riders of one microbatch share its id; its rows are their distinct texts
    rides = {}
    for text, r in zip(_texts(), results):
        rides.setdefault((r.replica, r.result.microbatch), []).append((text, r.result))
    for rs in rides.values():
        assert {x.rows for _, x in rs} == {len({t for t, _ in rs})}


def test_stages_are_the_sums_of_their_spans(db, tracing):
    before = db.stats().stage_seconds
    db.query(MEMBERS_OF.format(uni="Univ0"))  # builds the plan: every stage runs
    db.query(MEMBERS_OF.format(uni="Univ1"))  # a cached plan
    db.execute_many([WORKS_FOR.format(uni=u) for u in ("Univ0", "Univ1", "Univ0")])
    after = db.stats().stage_seconds
    got = spans.drain()
    for stage in STAGES:
        total = sum(s.seconds for s in got if s.name == stage)
        assert after[stage] - before.get(stage, 0.0) == pytest.approx(total, rel=1e-9), stage
    by_id = {s.id: s for s in got}
    for s in got:
        for stage, parts in PARTS.items():
            if s.name in parts:
                parent = by_id[s.parent]
                assert parent.name == stage, (s, parent)
                assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for stage, parts in PARTS.items():
        for p in (s for s in got if s.name == stage):
            kids = [s.seconds for s in got if s.parent == p.id and s.name in parts]
            assert sum(kids) <= p.seconds
            assert kids or (stage == "plan" and p.attrs["hit"])  # a cached plan builds nothing


@pytest.mark.parametrize("riders,bucket", [(1, 1), (3, 4)])
def test_counters_count_scans_and_rows(db, riders, bucket):
    texts = [MEMBERS_OF.format(uni=u) for u in ("Univ0", "Univ1", "Univ2")[:riders]]
    before = db.stats()
    results = db.execute_many(texts)
    after = db.stats()
    eng = db._engine
    plan, _ = eng.plan_for(eng.prepare(texts[0])[1], bucket)
    n_vars = plan.base_soi.n_vars
    moved = {k: getattr(after, k) - getattr(before, k) for k in COUNTERS}
    # what the prunes of the riders' distinct sets visited, one by one
    consts = [eng.prepare(t)[1].constants for t in texts]
    chi, _ = plan.execute(consts + [consts[-1]] * (bucket - riders))  # padded as served
    with pruning.counting() as visits:
        for i in range(riders):
            pruning.prune_triples(plan.base_soi, chi[plan.layout.chi_slice(i)], db.graph)
    assert moved["prune_triples_scanned"] == visits.triples
    assert 0 < moved["prune_triples_scanned"] < riders * len(
        plan.base_soi.pattern_edges) * db.graph.n_edges
    assert [moved[k] for k in SIDES] == [visits.by_subject, visits.by_object, visits.by_label]
    assert sum(moved[k] for k in SIDES) == riders * len(plan.base_soi.pattern_edges)
    assert moved["prune_survivors"] == sum(r.stats.n_after for r in results)
    assert moved["rows_solved"] == bucket * n_vars
    assert moved["rows_useful"] == riders * n_vars
    assert {r.batch for r in results} == {bucket}
    assert {r.rows for r in results} == {riders}
    assert len({r.microbatch for r in results}) == 1


def test_unresolved_labels_are_not_scanned(db):
    before = db.stats()
    rs = db.query("{ ?s noSuchLabel ?o . ?s memberOf ?d }")
    after = db.stats()
    moved = {k: getattr(after, k) - getattr(before, k) for k in COUNTERS}
    assert sum(moved[k] for k in SIDES) == 1  # memberOf alone
    assert rs.stats.per_edge_survivors == [0, 0]
    # the fixpoint leaves ?s and ?d no candidates, so memberOf's subject
    # side holds no triple to visit
    assert moved["prune_edges_by_subject"] == 1
    assert moved["prune_triples_scanned"] == 0


def test_a_failed_prune_still_commits_its_solve(db, monkeypatch):
    db.query(MEMBERS_OF.format(uni="Univ0"))  # the plan, built
    before = db.stats()

    def fail(*args, **kwargs):
        raise RuntimeError("prune failed")

    monkeypatch.setattr(pruning, "prune_triples", fail)
    with pytest.raises(RuntimeError, match="prune failed"):
        db.query(MEMBERS_OF.format(uni="Univ1"))
    after = db.stats()
    assert after.microbatches == before.microbatches + 1
    assert sum(after.engine_counts.values()) == after.microbatches
    assert after.rows_solved > before.rows_solved
    for stage in ("plan", "solve", "solve.sweeps"):
        assert after.stage_seconds[stage] > before.stage_seconds[stage], stage
    assert after.prune_triples_scanned == before.prune_triples_scanned


def test_the_spans_clock_is_monotonic():
    # a stage's seconds cannot go negative when the wall clock is stepped;
    # records reach the profiler's clock through one offset (the next test)
    assert spans.clock is time.perf_counter_ns
    assert time.get_clock_info("perf_counter").monotonic


def test_tracing_off_keeps_no_record_and_stages_still_move(db):
    spans.disable()
    spans.drain()
    before = db.stats()
    results = _serve(db, _texts()[:4])
    assert all(r.ok for r in results)
    assert spans.drain() == []
    after = db.stats()
    # the front end parses; the replicas' engines plan, solve and prune
    assert after.stage_seconds["parse"] > before.stage_seconds.get("parse", 0.0)
    assert spans.requests() is None and spans.new_id() is None
    db.query(MEMBERS_OF.format(uni="Univ0"))
    moved = db.stats()
    for k in COUNTERS:
        if k not in SIDES:
            assert getattr(moved, k) > getattr(after, k), k
    assert sum(getattr(moved, k) - getattr(after, k) for k in SIDES) == 2
    for stage in STAGES:
        assert moved.stage_seconds[stage] > after.stage_seconds.get(stage, 0.0), stage


def test_a_span_brackets_the_profilers_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    spans.drain()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = spans.begin()
            with record_function("spans.clock"):
                sum(range(10_000))
            t1 = spans.end("clock", t0)  # its seconds
    finally:
        spans.disable()
    (mine,) = spans.drain()
    assert (mine.start_ns, mine.seconds) == (spans.epoch_ns(t0), t1)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "spans.clock"]
    assert mine.start_ns <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= mine.end_ns


def test_a_span_whose_end_an_exception_skipped_leaves_its_parent_whole(tracing):
    outer = spans.begin()
    with pytest.raises(RuntimeError):
        spans.begin()  # its end never comes
        raise RuntimeError
    spans.end("outer", outer)
    after = spans.begin()
    spans.end("after", after)
    got = {s.name: s for s in spans.drain()}
    assert set(got) == {"outer", "after"}
    assert got["outer"].parent is None and got["after"].parent is None


@pytest.mark.gpu
def test_solve_sweeps_brackets_its_k1_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    db = GraphDB(synth.lubm_like(n_universities=2, seed=0), engine="sparse")
    text = MEMBERS_OF.format(uni="Univ0")
    db.query(text)  # builds the kernels and the plan
    torch.cuda.synchronize()
    spans.drain()
    spans.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            db.query(MEMBERS_OF.format(uni="Univ1"))
            torch.cuda.synchronize()
    finally:
        spans.disable()
    (sweeps,) = [s for s in spans.drain() if s.name == "solve.sweeps"]
    k1 = [e for e in prof.profiler.kineto_results.events()
          if str(e.device_type()).endswith("CUDA") and "segor_blocks_kernel" in e.name()]
    assert k1
    for e in k1:
        assert sweeps.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= sweeps.end_ns
