"""`repro_torch.serve` on the CPU, case for case the JAX package's
``tests/test_serve.py``: deficit-round-robin fairness, latency histograms,
admission control (queue bound / cost cap / deadlines), replica routing
across mutation epochs, streaming delivery, per-request flush isolation in
Session, thread-consistent Engine.stats() snapshots, the real background
flush timer, and the batching invariant under concurrent sessions.  Last,
the same request streams through the JAX ``AsyncServer`` and the port's
give the same outcomes, survivors and bindings per request.
"""
import asyncio
import math
import threading
import time

import numpy as np
import pytest

from repro.data import synth as ref_synth
from repro.db import GraphDB as RefGraphDB
from repro.serve import AsyncServer as RefAsyncServer
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.serve import (
    AsyncServer,
    DeficitRoundRobin,
    LatencyHistogram,
    ReplicaRouter,
    ServeMetrics,
    stream_pages,
)

MEMBERS_OF = "{{ ?d subOrganizationOf {uni} . ?s memberOf ?d }}"


@pytest.fixture()
def db():
    return GraphDB(synth.lubm_like(n_universities=2, seed=0), device="cpu")


def _prepared(db, text):
    return db._engine.prepare(db._coerce(text))


# --------------------------------------------------------------------- #
# fairness: deficit round robin
# --------------------------------------------------------------------- #
def test_drr_fifo_within_tenant():
    drr = DeficitRoundRobin(quantum=8.0)
    for i in range(5):
        drr.enqueue("a", i)
    assert len(drr) == 5
    taken = drr.take(5)
    assert [item for _, item in taken] == [0, 1, 2, 3, 4]
    assert len(drr) == 0


def test_drr_storm_cannot_starve_trickle():
    # alice storms 20 requests ahead of bob's 2; one take(8) round with
    # quantum 4 must still carry both of bob's — the head-of-line
    # guarantee admission control alone cannot give
    drr = DeficitRoundRobin(quantum=4.0)
    for i in range(20):
        drr.enqueue("alice", f"a{i}")
    for i in range(2):
        drr.enqueue("bob", f"b{i}")
    batch = drr.take(8)
    by_tenant = {}
    for tenant, item in batch:
        by_tenant.setdefault(tenant, []).append(item)
    assert by_tenant["bob"] == ["b0", "b1"]
    assert len(by_tenant["alice"]) == 6  # alice keeps the leftover budget


def test_drr_weights_converge_to_ratio():
    # weight 3:1 with quantum 1 dequeues exactly 3 a's per b while both
    # stay backlogged
    drr = DeficitRoundRobin(quantum=1.0, weights={"a": 3.0, "b": 1.0})
    for i in range(30):
        drr.enqueue("a", i)
        drr.enqueue("b", i)
    counts = {"a": 0, "b": 0}
    for _ in range(8):
        for tenant, _item in drr.take(4):
            counts[tenant] += 1
    assert counts == {"a": 24, "b": 8}


def test_drr_idle_tenant_banks_nothing():
    drr = DeficitRoundRobin(quantum=4.0)
    drr.enqueue("a", "x")
    assert drr.take(4) == [("a", "x")]
    # emptied mid-round: deficit resets, so a later burst gets no credit
    assert drr._deficit["a"] == 0.0
    assert drr.tenants == ()


def test_drr_drain_returns_everything():
    drr = DeficitRoundRobin(quantum=2.0)
    for i in range(7):
        drr.enqueue("a" if i % 2 else "b", i)
    out = drr.drain()
    assert sorted(item for _, item in out) == list(range(7))
    assert len(drr) == 0 and drr.take(4) == []


def test_drr_rejects_nonpositive_quantum():
    with pytest.raises(ValueError):
        DeficitRoundRobin(quantum=0.0)


# --------------------------------------------------------------------- #
# metrics: histogram + consistent snapshot
# --------------------------------------------------------------------- #
def test_latency_histogram_quantiles_bound_truth():
    h = LatencyHistogram()
    samples = [i * 1e-3 for i in range(1, 101)]  # 1..100 ms
    for s in samples:
        h.add(s)
    assert h.n == 100
    assert h.mean == pytest.approx(sum(samples) / 100)
    # geometric buckets: the quantile is an upper edge within +50% of truth
    for q, truth in [(0.50, 0.050), (0.99, 0.099)]:
        est = h.quantile(q)
        assert truth <= est <= truth * 1.5


def test_latency_histogram_empty_and_overflow():
    h = LatencyHistogram()
    assert h.quantile(0.5) == 0.0 and h.mean == 0.0
    h.add(1e9)  # beyond the last edge: overflow bucket, inf quantile
    assert h.quantile(0.99) == float("inf")
    assert h.summary()["n"] == 1


def test_serve_metrics_snapshot_accounting():
    m = ServeMetrics()
    for _ in range(4):
        m.on_submit("a")
    m.on_shed("a", "overloaded")
    m.on_shed("a", "deadline")
    m.on_admit(depth=2)
    m.on_admit(depth=1)
    m.on_complete("a", queue_s=0.001, total_s=0.002)
    m.on_complete("a", queue_s=0.001, total_s=0.002)
    snap = m.snapshot()
    assert snap.submitted == 4 and snap.admitted == 2
    assert snap.shed == {"overloaded": 1, "cost": 0, "deadline": 1}
    assert snap.shed_total == 2 and snap.shed_rate == 0.5
    assert snap.completed == 2 and snap.queue_peak == 2
    assert snap.per_tenant["a"]["completed"] == 2
    assert snap.latency["n"] == 2


# --------------------------------------------------------------------- #
# router: least-in-flight routing + epoch fencing
# --------------------------------------------------------------------- #
def test_router_routes_least_in_flight(db):
    router = ReplicaRouter(db, n_replicas=2)
    r1, r2 = router.route(), router.route()
    assert r1 is not r2  # second batch overlaps on the other replica
    router.release(r1)
    assert router.route() is r1  # back to the now-idle one
    with pytest.raises(ValueError):
        ReplicaRouter(db, n_replicas=0)


def test_router_isolates_poisoned_request(db):
    router = ReplicaRouter(db, n_replicas=1)
    good = _prepared(db, MEMBERS_OF.format(uni="Univ0"))
    expected = len(db.query(MEMBERS_OF.format(uni="Univ0")))
    boom = RuntimeError("poisoned")
    engine = router.replicas[0].engine
    orig = engine.execute_prepared

    def failing(batch):
        if len(batch) > 1:
            raise RuntimeError("batched execution failed")
        if batch[0] is poison:
            raise boom
        return orig(batch)

    poison = _prepared(db, MEMBERS_OF.format(uni="Univ1"))
    engine.execute_prepared = failing
    outcomes, name = router.execute_isolated([good, poison, good])
    assert name == "r0"
    assert len(outcomes[0]) == expected and len(outcomes[2]) == expected
    assert outcomes[1] is boom


def test_router_fence_advances_every_replica(db):
    router = ReplicaRouter(db, n_replicas=3)
    router.execute_isolated([_prepared(db, MEMBERS_OF.format(uni="Univ0"))])
    db.insert([("DeptX", "subOrganizationOf", "Univ0")])
    fenced = router.fence()
    assert fenced == db.version
    assert router.versions() == [db.version] * 3


# --------------------------------------------------------------------- #
# server: admission control
# --------------------------------------------------------------------- #
def test_server_ok_path_matches_direct_query(db):
    queries = [MEMBERS_OF.format(uni=f"Univ{i % 2}") for i in range(6)]
    truths = [frozenset(db.query(q).survivor_triples()) for q in queries]

    async def go():
        async with AsyncServer(db, replicas=1, max_queue=32,
                               max_delay_ms=1.0) as server:
            futs = [server.submit(q, tenant=f"t{i % 2}")
                    for i, q in enumerate(queries)]
            return await asyncio.gather(*futs)

    results = asyncio.run(go())
    assert all(r.ok for r in results)
    for r, truth in zip(results, truths):
        assert frozenset(r.result.survivor_triples()) == truth
        assert r.total_ms >= r.queue_ms >= 0.0
        assert r.replica == "r0"


def test_server_metrics_drain_invariant(db):
    async def go():
        async with AsyncServer(db, replicas=1, max_delay_ms=1.0) as server:
            futs = [server.submit(MEMBERS_OF.format(uni="Univ0"))
                    for _ in range(5)]
            futs.append(server.submit("not sparql at all }}{{"))
            futs.append(server.submit(MEMBERS_OF.format(uni="Univ1"),
                                      deadline_ms=0.0))
            await asyncio.gather(*futs)
            return server.metrics.snapshot()

    snap = asyncio.run(go())
    # every submitted request reaches exactly one terminal outcome
    assert snap.submitted == snap.completed + snap.shed_total + snap.errors
    assert snap.completed == 5 and snap.errors == 1
    assert snap.shed == {"overloaded": 0, "cost": 0, "deadline": 1}
    assert snap.queue_depth == 0


def test_server_sheds_overloaded_beyond_queue_bound(db):
    async def go():
        # max_queue=1 and a long flush timer: the first request is
        # admitted and parked, the burst behind it must shed immediately
        async with AsyncServer(db, replicas=1, max_queue=1, max_batch=8,
                               max_delay_ms=500.0) as server:
            futs = [server.submit(MEMBERS_OF.format(uni="Univ0"))
                    for _ in range(4)]
            shed_now = [f.done() for f in futs]
            results = await asyncio.gather(*futs)
            return shed_now, results

    shed_now, results = asyncio.run(go())
    assert [r.outcome for r in results] == ["ok"] + ["overloaded"] * 3
    # the backpressure contract: a shed is a fast no, resolved at submit
    assert shed_now == [False, True, True, True]
    assert "queue full" in results[1].detail


def test_server_cost_cap_rejects_expensive_queries(db):
    async def go():
        async with AsyncServer(db, replicas=1, max_delay_ms=1.0,
                               cost_cap=1e-9) as server:
            capped = await server.submit(MEMBERS_OF.format(uni="Univ0"))
        async with AsyncServer(db, replicas=1, max_delay_ms=1.0,
                               cost_cap=1e18) as server:
            roomy = await server.submit(MEMBERS_OF.format(uni="Univ0"))
        return capped, roomy

    capped, roomy = asyncio.run(go())
    assert capped.outcome == "cost" and "cap" in capped.detail
    assert roomy.ok


def test_server_deadline_sheds_at_admission_and_in_queue(db):
    async def go():
        async with AsyncServer(db, replicas=1, max_batch=8,
                               max_delay_ms=120.0) as server:
            at_admission = await server.submit(
                MEMBERS_OF.format(uni="Univ0"), deadline_ms=0.0)
            # admitted, but the flush timer (120ms) outlives the 1ms
            # deadline: shed at dispatch, never executed
            in_queue = await server.submit(
                MEMBERS_OF.format(uni="Univ0"), deadline_ms=1.0)
            return at_admission, in_queue

    at_admission, in_queue = asyncio.run(go())
    assert at_admission.outcome == "deadline"
    assert at_admission.detail == "expired at admission"
    assert in_queue.outcome == "deadline"
    assert in_queue.detail == "deadline exceeded in queue"
    assert in_queue.queue_ms > 0.0 and in_queue.result is None


def test_server_parse_error_resolves_own_future(db):
    async def go():
        async with AsyncServer(db, replicas=1, max_delay_ms=1.0) as server:
            bad = server.submit("{{ ?x noclosingbrace")
            good = server.submit(MEMBERS_OF.format(uni="Univ0"))
            return await asyncio.gather(bad, good)

    bad, good = asyncio.run(go())
    assert bad.outcome == "error" and isinstance(bad.error, Exception)
    assert good.ok


def test_server_tenant_fairness_end_to_end(db):
    async def go():
        async with AsyncServer(db, replicas=1, max_queue=64, max_batch=4,
                               max_delay_ms=1.0) as server:
            futs = [server.submit(MEMBERS_OF.format(uni=f"Univ{i % 2}"),
                                  tenant="alice") for i in range(16)]
            futs += [server.submit(MEMBERS_OF.format(uni="Univ0"),
                                   tenant="bob") for _ in range(2)]
            results = await asyncio.gather(*futs)
            return results, server.metrics.snapshot()

    results, snap = asyncio.run(go())
    assert all(r.ok for r in results)
    assert snap.per_tenant["bob"]["completed"] == 2
    assert snap.per_tenant["alice"]["completed"] == 16


# --------------------------------------------------------------------- #
# server: replica consistency across a mutation epoch
# --------------------------------------------------------------------- #
def test_server_no_torn_reads_across_mutation_epoch(db):
    q = MEMBERS_OF.format(uni="Univ0")
    truth0 = frozenset(db.query(q).survivor_triples())
    delta = [("DeptNew", "subOrganizationOf", "Univ0"),
             ("StudentNew", "memberOf", "DeptNew")]

    async def go():
        async with AsyncServer(db, replicas=2, max_delay_ms=1.0) as server:
            wave0 = await asyncio.gather(
                *[server.submit(q) for _ in range(4)])
            db.insert(delta)  # a multi-triple delta: torn reads would show
            mid = await asyncio.gather(
                *[server.submit(q) for _ in range(4)])
            fenced = await server.fence()
            wave1 = await asyncio.gather(
                *[server.submit(q) for _ in range(4)])
            return wave0, mid, fenced, wave1

    wave0, mid, fenced, wave1 = asyncio.run(go())
    truth1 = frozenset(db.query(q).survivor_triples())
    assert truth0 != truth1
    for r in wave0:
        assert frozenset(r.result.survivor_triples()) == truth0
    for r in mid:
        # either epoch is legal before the fence — but always *exactly*
        # one of them: no reader ever observes a half-applied delta
        assert frozenset(r.result.survivor_triples()) in (truth0, truth1)
    assert fenced == db.version
    for r in wave1:
        # after the fence every replica serves the new epoch
        assert frozenset(r.result.survivor_triples()) == truth1


def test_stream_pages_covers_result_exactly(db):
    rs = db.query(MEMBERS_OF.format(uni="Univ0"))
    whole = rs.page(0, len(rs))
    assert len(whole) == len(rs) > 10

    async def go():
        pages = []
        async for page in stream_pages(rs, page_size=7):
            pages.append(page)
        return pages

    pages = asyncio.run(go())
    assert all(len(p) <= 7 for p in pages)
    assert [t for p in pages for t in p] == whole


# --------------------------------------------------------------------- #
# Session flush isolation (regression)
# --------------------------------------------------------------------- #
def test_session_flush_isolates_poisoned_request(db, monkeypatch):
    orig = db._execute_prepared

    def failing(batch):
        # fail the batched path whenever the poison rides along, and the
        # per-request retry only for the poison itself
        if any(inst is not None and "PoisonU" in inst.constants
               for _, inst in batch):
            raise RuntimeError("poisoned request")
        return orig(batch)

    monkeypatch.setattr(db, "_execute_prepared", failing)
    with db.session(max_delay_ms=10_000, max_pending=16) as session:
        good0 = session.submit(MEMBERS_OF.format(uni="Univ0"))
        bad = session.submit(MEMBERS_OF.format(uni="PoisonU"))
        good1 = session.submit(MEMBERS_OF.format(uni="Univ1"))
        assert session.flush() == 3
        # regression: the poisoned request used to leave ALL three
        # futures unresolved; now every sibling resolves with its result
        assert good0.done() and bad.done() and good1.done()
        assert len(good0.result()) == len(db.query(
            MEMBERS_OF.format(uni="Univ0")))
        assert len(good1.result()) == len(db.query(
            MEMBERS_OF.format(uni="Univ1")))
        with pytest.raises(RuntimeError, match="poisoned request"):
            bad.result()


# --------------------------------------------------------------------- #
# Engine.stats() consistency under a multithreaded hammer
# --------------------------------------------------------------------- #
def test_engine_stats_consistent_under_threads(db):
    db.query(MEMBERS_OF.format(uni="Univ0"))  # warm the traces first
    stop = threading.Event()
    errors = []

    def hammer(k):
        i = 0
        try:
            while not stop.is_set():
                db.query(MEMBERS_OF.format(uni=f"Univ{(i + k) % 2}"))
                i += 1
        except Exception as exc:  # pragma: no cover - the assert reports
            errors.append(exc)

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    try:
        last = -1
        deadline = time.monotonic() + 1.5
        while time.monotonic() < deadline:
            m = db.stats()
            # the snapshot invariant: engine_counts is incremented in the
            # same critical section as microbatches, so no interleaving
            # may ever expose sum(engine_counts) != microbatches
            assert sum(m.engine_counts.values()) == m.microbatches
            assert m.microbatches >= last
            last = m.microbatches
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors
    assert db.stats().microbatches > 1  # the hammer actually ran


# --------------------------------------------------------------------- #
# concurrent sessions keep the batching invariant
# --------------------------------------------------------------------- #
def test_concurrent_sessions_batching_invariant(db):
    T, N, cap = 3, 8, 4
    db.query(MEMBERS_OF.format(uni="Univ0"))  # warm
    base = db.stats().microbatches
    errors = []

    def worker(t):
        try:
            with db.session(max_delay_ms=60_000, max_pending=cap) as s:
                futs = [s.submit(MEMBERS_OF.format(uni=f"T{t}U{i}"))
                        for i in range(N)]
                for f in futs:
                    f.result()  # unknown constants: empty, never an error
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    # each session's bucket cap bounds its solves at ceil(N / cap); the
    # invariant must survive interleaved flushes from concurrent threads
    assert db.stats().microbatches - base <= T * math.ceil(N / cap)


# --------------------------------------------------------------------- #
# the background flusher makes max_delay_ms a real timer
# --------------------------------------------------------------------- #
def test_background_flusher_fires_without_further_calls(db):
    db.query(MEMBERS_OF.format(uni="Univ0"))  # warm: keep the flush cheap
    session = db.session(max_delay_ms=20.0, auto_flush=True)
    try:
        fut = session.submit(MEMBERS_OF.format(uni="Univ1"))
        # no flush(), no result(), no further submit: only the timer can
        # resolve this future
        deadline = time.monotonic() + 5.0
        while not fut.done() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fut.done()
        assert session.flushes == 1 and session.pending == 0
        assert len(fut.result()) == len(db.query(
            MEMBERS_OF.format(uni="Univ1")))
    finally:
        session.close()


# --------------------------------------------------------------------- #
# spec-calibrated admission pricing is commensurate
# with measured reality
# --------------------------------------------------------------------- #
def test_admission_estimate_calibrated_within_measured_envelope(db):
    """With a MachineSpec the admission envelope is priced in *seconds* —
    so it must land within a bounded ratio of a measured warm solve, unlike
    the hand-tuned arbitrary units (off by ~6 orders of magnitude).  The
    spec uses ceilings of a modest CPU container; the wide 1e-3..1e3 band
    absorbs the machine-to-machine spread while still ruling out any
    unit-confusion regression.
    """
    from repro_torch.core import sparql
    from repro_torch.engine import cost as cost_mod
    from repro_torch.engine.machine import MachineSpec

    spec = MachineSpec(
        backend="cpu", device_kind="cpu", fingerprint="test-cpu-container",
        n_devices=1, stream_bytes_per_s=2e9, dense_elems_per_s=2.6e10,
        packed_words_per_s=1e8, packed_words_per_s_xla=3.4e8,
        fused_words_per_s=3.4e8, kernel_launch_s=4e-4, dispatch_s=3.2e-5,
        trace_s=0.22,
    )
    text = MEMBERS_OF.format(uni="Univ0")
    db.query(text)  # warm: plan cached, jit traced
    measured = min(
        _timed(lambda: db.query(text)) for _ in range(5)
    )
    est = cost_mod.admission_estimate(db.graph, sparql.parse(text), spec=spec)
    assert est > 0.0
    ratio = est / measured
    assert 1e-3 <= ratio <= 1e3, (
        f"calibrated admission {est:.3g}s vs measured {measured:.3g}s "
        f"(ratio {ratio:.3g})"
    )
    # the hand-tuned envelope is NOT commensurate: same formula, arb units
    arb = cost_mod.admission_estimate(db.graph, sparql.parse(text))
    assert arb / measured > 1e3


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# --------------------------------------------------------------------- #
# the port's server against the JAX package's
# --------------------------------------------------------------------- #
PARITY_QUERIES = [MEMBERS_OF.format(uni=f"Univ{i % 2}") for i in range(6)] + [
    "{ ?s memberOf ?d . ?d subOrganizationOf ?u }",
    "{ { ?s memberOf ?d } UNION { ?s worksFor ?d } } AND "
    "{ ?d subOrganizationOf Univ1 }",
    "{ ?s memberOf Dept0_0 } AND { ?s noSuchLabel ?x }",
    "not sparql at all }}{{",
]


def _serve_stream(db, server_cls, churn):
    """Two waves of PARITY_QUERIES from two tenants (plus one request shed
    at admission), with a shape-stable churn, a dictionary-growing insert
    and a fence between them when ``churn``."""
    async def wave(server):
        futs = [server.submit(q, tenant=f"t{i % 2}")
                for i, q in enumerate(PARITY_QUERIES)]
        futs.append(server.submit(PARITY_QUERIES[0], deadline_ms=0.0))
        return await asyncio.gather(*futs)

    async def go():
        async with server_cls(db, replicas=2, max_queue=64, max_batch=4,
                              max_delay_ms=1.0,
                              default_deadline_ms=30_000.0) as server:
            first = await wave(server)
            if churn:
                g = db.graph
                row = g.triples[0]
                t = (g.node_names[row[0]], g.label_names[row[1]],
                     g.node_names[row[2]])
                db.delete([t])
                mid = await wave(server)
                db.insert([t])
                db.insert([("DeptNew", "subOrganizationOf", "Univ0"),
                           ("StudentNew", "memberOf", "DeptNew")])
                await server.fence()
                first += mid
            return first + await wave(server)

    return asyncio.run(go())


@pytest.mark.parametrize("churn", [False, True])
def test_serving_matches_reference_server(churn):
    got = _serve_stream(
        GraphDB(synth.lubm_like(n_universities=2, seed=0), device="cpu"),
        AsyncServer, churn)
    want = _serve_stream(
        RefGraphDB(ref_synth.lubm_like(n_universities=2, seed=0)),
        RefAsyncServer, churn)
    assert len(got) == len(want) == (3 if churn else 2) * (len(PARITY_QUERIES) + 1)
    assert [r.outcome for r in got] == [r.outcome for r in want]
    assert {r.outcome for r in got} == {"ok", "error", "deadline"}
    for a, b in zip(got, want):
        if not a.ok:
            continue
        assert a.result.snapshot.n_edges == b.result.snapshot.n_edges
        assert np.array_equal(a.result.survivor_mask, b.result.survivor_mask)
        assert a.result.variables == b.result.variables
        for var in a.result.variables:
            assert np.array_equal(a.result.binding_mask(var),
                                  b.result.binding_mask(var)), var
        assert list(a.result.survivor_triples()) == list(b.result.survivor_triples())


# --------------------------------------------------------------------- #
# launch counts under concurrent replicas
# --------------------------------------------------------------------- #
def test_launch_counts_survive_concurrent_threads():
    """Serving replicas launch kernels from several threads at once; no
    count may be lost (the counts are what show a path ran its kernels)."""
    import sys

    from repro_torch import kernels

    n_threads, per_thread = 16, 2000
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait(timeout=30)
        for _ in range(per_thread):
            kernels.count_launch("stress_probe")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    counts = kernels.launch_counts()
    kernels.LAUNCHES.pop("stress_probe")
    assert counts["stress_probe"] == n_threads * per_thread
