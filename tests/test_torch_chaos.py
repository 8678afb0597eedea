"""The failure plane of `repro_torch.serve` on the CPU, case for case the
JAX package's ``tests/test_chaos.py``: deterministic fault injection
(`repro_torch.faults`), replica health / quarantine / epoch-fenced rebuild,
deadline-budgeted retry and hedging, the solve watchdog behind the explicit
``timeout`` outcome, the unresolved-future fixes, and the exactly-once
property under random seeded fault schedules (ok results bit-identical to
the fault-free ``solve_worklist`` oracle)."""
import asyncio
import time

import numpy as np
import pytest
from tests._hyp import given, settings, st

from repro_torch.core import dualsim, pruning, soi, sparql
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.faults import (
    FaultPlan,
    InjectedCrash,
    InjectedFault,
    InjectedPoison,
    InjectedReject,
)
from repro_torch.serve import (
    HEALTHY,
    OUTCOMES,
    QUARANTINED,
    SUSPECT,
    AsyncServer,
    ReplicaRouter,
)

MEMBERS_OF = "{{ ?d subOrganizationOf {uni} . ?s memberOf ?d }}"


@pytest.fixture()
def db():
    return GraphDB(synth.lubm_like(n_universities=2, seed=0), device="cpu")


def _prepared(db, text):
    return db._engine.prepare(db._coerce(text))


def _oracle_mask(g, text):
    """Fault-free ground truth: parse -> SOI -> solve_worklist -> prune."""
    q = sparql.parse(text)
    mask = np.zeros(g.n_edges, dtype=bool)
    for part in sparql.union_split(q):
        s = soi.build_soi(part)
        c = soi.compile_soi(s, g)
        chi, _ = dualsim.solve_worklist(c, g)
        m, _ = pruning.prune_triples(s, chi, g)
        mask |= m
    return mask


# --------------------------------------------------------------------- #
# FaultPlan semantics
# --------------------------------------------------------------------- #
def test_fault_plan_disarmed_is_noop():
    plan = (
        FaultPlan(7)
        .crash_replica("r0", at_batch=1)
        .poison_matching("Poison")
        .reject_dispatch(at_dispatch=1)
        .fail_refresh("r1")
    )
    # not armed: every hook is silent
    plan.on_batch_start("r0")
    plan.on_dispatch()
    plan.on_refresh("r1")
    plan.on_execute_prepared([("q", None)])
    assert plan.solve_penalty("r0", 1.0) == 0.0
    assert plan.counts() == {}


def test_fault_plan_crash_persists_until_heal():
    plan = FaultPlan().crash_replica("r0", at_batch=2).arm()
    plan.on_batch_start("r0")  # batch 1: survives
    with pytest.raises(InjectedCrash):
        plan.on_batch_start("r0")  # batch 2: crashes
    with pytest.raises(InjectedCrash):
        plan.on_batch_start("r0")  # stays crashed (fast failure)
    plan.on_batch_start("r1")  # other replicas unaffected
    assert plan.crash_fired("r0")["batch"] == 2.0
    plan.heal("r0")
    plan.on_batch_start("r0")  # a rebuilt replica serves again
    assert plan.counts()["crash"] == 2


def test_fault_plan_reject_window_and_refresh_budget():
    plan = FaultPlan().reject_dispatch(at_dispatch=2).fail_refresh("r0").arm()
    plan.on_dispatch()  # dispatch 1 passes
    with pytest.raises(InjectedReject):
        plan.on_dispatch()  # dispatch 2 rejected
    plan.on_dispatch()  # window closed
    with pytest.raises(InjectedFault):
        plan.on_refresh("r0")
    plan.on_refresh("r0")  # budget of 1 consumed


def test_fault_plan_poison_matches_constants(db):
    plan = FaultPlan().poison_matching("Poison").arm()
    clean = _prepared(db, MEMBERS_OF.format(uni="Univ0"))
    bad = _prepared(db, MEMBERS_OF.format(uni="PoisonX"))
    plan.on_execute_prepared([clean])
    assert not plan.matches_poison(clean)
    assert plan.matches_poison(bad)
    with pytest.raises(InjectedPoison):
        plan.on_execute_prepared([clean, bad])


# --------------------------------------------------------------------- #
# router health plane
# --------------------------------------------------------------------- #
def test_router_quarantines_fast_failing_replica(db):
    # the amplification regression: raw least-in-flight would keep feeding
    # a fast-failing replica (low in-flight -> more traffic); the health
    # plane must cap its failures and quarantine it
    plan = FaultPlan().crash_replica("r0", at_batch=1).arm()
    router = ReplicaRouter(db, 3, fault_plan=plan, auto_rebuild=False)
    prepared = _prepared(db, MEMBERS_OF.format(uni="Univ0"))
    failures = ok = 0
    for _ in range(30):
        try:
            out, _name = router.execute_isolated([prepared])
            assert not isinstance(out[0], Exception)
            ok += 1
        except InjectedFault:
            failures += 1
    health = {h["name"]: h for h in router.health()}
    assert health["r0"]["state"] == QUARANTINED
    # suspect probing re-checks the broken replica a bounded number of
    # times; it must NOT capture a traffic share
    assert failures <= 5
    assert ok >= 25
    agg = router.aggregate()
    assert agg["health"]["r0"] == QUARANTINED
    assert agg["quarantines"] == 1
    events = [e["event"] for e in router.events() if e["replica"] == "r0"]
    assert "suspect" in events and "quarantined" in events


def test_router_rebuilds_crashed_replica_bit_identical(db):
    text = MEMBERS_OF.format(uni="Univ0")
    plan = FaultPlan().crash_replica("r0", at_batch=1).arm()
    router = ReplicaRouter(
        db, 2, fault_plan=plan, rebuild_backoff_s=0.01
    )
    prepared = _prepared(db, text)
    # drive traffic until the crash is noticed, probed, and quarantined;
    # the rebuild thread then heals the injected crash and swaps engines
    for _ in range(30):
        try:
            router.execute_isolated([prepared])
        except InjectedFault:
            pass
    assert router.wait_rebuilt(timeout=10.0)
    r0 = router.replicas[0]
    health = {h["name"]: h for h in router.health()}
    assert health["r0"]["state"] == HEALTHY
    assert health["r0"]["epoch"] == 1 and health["r0"]["rebuilds"] == 1
    events = [e["event"] for e in router.events() if e["replica"] == "r0"]
    assert events.count("rebuilt") == 1
    # epoch-fenced re-admission: the rebuilt engine serves, and its results
    # are bit-identical to the fault-free oracle
    with router._route_lock:  # count the slot release() will return
        r0.in_flight += 1
    out, name = router.execute_on(r0, [prepared])
    assert name == "r0" and not isinstance(out[0], Exception)
    assert np.array_equal(out[0].survivor_mask, _oracle_mask(db.graph, text))


def test_router_fence_partial_failure_marks_suspect(db):
    plan = FaultPlan().fail_refresh("r1").arm()
    router = ReplicaRouter(db, 2, fault_plan=plan, auto_rebuild=False)
    prepared = _prepared(db, MEMBERS_OF.format(uni="Univ0"))
    router.execute_isolated([prepared])  # warm one replica on v0
    db.insert([("DeptX", "subOrganizationOf", "Univ0")])
    v = router.fence()
    assert v == db.version
    agg = router.aggregate()
    assert agg["fence_failures"] == 1
    assert agg["fence_partial"] == ["r1"]
    # the fleet is half-fenced but *recorded*: r0 advanced, r1 is suspect
    assert router.versions()[0] == v
    health = {h["name"]: h for h in router.health()}
    assert health["r1"]["state"] == SUSPECT
    # the injected budget is spent: the next fence completes everywhere
    router.fence()
    assert router.versions() == [v, v]
    assert router.aggregate()["fence_partial"] == []


# --------------------------------------------------------------------- #
# server failure handling
# --------------------------------------------------------------------- #
def test_server_pool_shutdown_resolves_all_futures(db):
    # executor rejection after pool shutdown used to
    # leak every live future; now they all resolve outcome="error"
    async def go():
        async with AsyncServer(
            db, replicas=1, max_batch=4, max_delay_ms=1.0
        ) as server:
            warm = await server.submit(MEMBERS_OF.format(uni="Univ0"))
            server._pool.shutdown(wait=False)
            futs = [
                server.submit(MEMBERS_OF.format(uni="Univ1"))
                for _ in range(3)
            ]
            results = await asyncio.gather(*futs)
            snap = server.metrics.snapshot()
        return warm, results, snap

    warm, results, snap = asyncio.run(go())
    assert warm.ok
    assert [r.outcome for r in results] == ["error"] * 3
    assert all("rejected" in r.detail for r in results)
    assert snap.submitted == snap.resolved  # nothing leaked


def test_server_injected_reject_resolves_batch(db):
    plan = FaultPlan().reject_dispatch(at_dispatch=1)

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, max_batch=4, max_delay_ms=1.0,
            default_deadline_ms=10_000.0,
        ) as server:
            warm = await server.submit(MEMBERS_OF.format(uni="Univ0"))
            plan.arm()
            rejected = await asyncio.gather(
                *[server.submit(MEMBERS_OF.format(uni="Univ0"))
                  for _ in range(3)]
            )
            after = await server.submit(MEMBERS_OF.format(uni="Univ1"))
            snap = server.metrics.snapshot()
        return warm, rejected, after, snap

    warm, rejected, after, snap = asyncio.run(go())
    assert warm.ok and after.ok
    assert [r.outcome for r in rejected] == ["error"] * 3
    assert all(isinstance(r.error, InjectedReject) for r in rejected)
    assert snap.submitted == snap.resolved


def test_server_retries_crashed_replica_on_another(db):
    text = MEMBERS_OF.format(uni="Univ0")
    plan = FaultPlan().crash_replica("r0", at_batch=1)

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, max_retries=2, max_batch=4,
            max_delay_ms=1.0, default_deadline_ms=30_000.0,
        ) as server:
            await asyncio.gather(
                *[server.submit(text) for _ in range(4)]
            )  # disarmed warmup
            plan.arm()
            results = []
            for _ in range(10):
                results.append(await server.submit(text))
            snap = server.metrics.snapshot()
            events = server.router.events()
        return results, snap, events

    results, snap, events = asyncio.run(go())
    # every request survived the crash via retry on the other replica
    assert all(r.ok for r in results)
    assert snap.retries >= 1
    assert snap.submitted == snap.resolved
    # the crash was noticed (auto-rebuild may already have healed r0)
    assert any(
        e["replica"] == "r0" and e["event"] == "suspect" for e in events
    )
    g = db.graph
    oracle = _oracle_mask(g, text)
    assert all(np.array_equal(r.result.survivor_mask, oracle) for r in results)


def test_server_poison_isolated_and_not_blamed_on_replica(db):
    plan = FaultPlan().poison_matching("Poison")
    good = MEMBERS_OF.format(uni="Univ0")
    bad = MEMBERS_OF.format(uni="PoisonX")

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, max_batch=4, max_delay_ms=1.0,
            default_deadline_ms=30_000.0,
        ) as server:
            await server.submit(good)
            plan.arm()
            futs = [server.submit(good), server.submit(bad),
                    server.submit(good), server.submit(good)]
            results = await asyncio.gather(*futs)
            health = server.router.health()
            snap = server.metrics.snapshot()
        return results, health, snap

    results, health, snap = asyncio.run(go())
    assert [r.outcome for r in results] == ["ok", "error", "ok", "ok"]
    assert isinstance(results[1].error, InjectedPoison)
    # poison travels with the request: the replica is NOT penalized
    assert all(h["state"] == HEALTHY for h in health)
    assert snap.errors == 1 and snap.submitted == snap.resolved


def test_server_watchdog_times_out_wedged_attempt(db):
    text = MEMBERS_OF.format(uni="Univ0")
    plan = FaultPlan().slow_replica("r0", extra_s=0.5)

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, max_retries=0, max_batch=2,
            max_delay_ms=1.0, default_deadline_ms=5_000.0,
        ) as server:
            for _ in range(6):
                await server.submit(text)  # disarmed warmup
            # pin the budget only after warmup: the cold first solve
            # (compile) legitimately exceeds any tight budget
            server.watchdog_budget = 0.150
            plan.arm()
            results = [await server.submit(text) for _ in range(8)]
            snap = server.metrics.snapshot()
            events = server.router.events()
        return results, snap, events

    results, snap, events = asyncio.run(go())
    outcomes = {r.outcome for r in results}
    assert outcomes <= {"ok", "timeout"} and "timeout" in outcomes
    timed_out = [r for r in results if r.outcome == "timeout"]
    assert all("watchdog" in r.detail for r in timed_out)
    assert snap.watchdog_overruns >= 1
    assert snap.timeouts == len(timed_out)
    # overruns feed the health plane: r0 went suspect at least once
    assert any(
        e["replica"] == "r0" and e["event"] == "suspect" for e in events
    )
    assert snap.submitted == snap.resolved


def test_server_watchdog_overrun_retries_to_ok(db):
    text = MEMBERS_OF.format(uni="Univ0")
    plan = FaultPlan().slow_replica("r0", extra_s=0.5)

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, max_retries=2, max_batch=2,
            max_delay_ms=1.0, default_deadline_ms=10_000.0,
        ) as server:
            for _ in range(6):
                await server.submit(text)
            server.watchdog_budget = 0.150  # post-warmup (see above)
            plan.arm()
            results = [await server.submit(text) for _ in range(8)]
            snap = server.metrics.snapshot()
        return results, snap

    results, snap = asyncio.run(go())
    assert all(r.ok for r in results)  # overruns retried on the fast replica
    assert snap.watchdog_overruns >= 1 and snap.retries >= 1
    assert snap.submitted == snap.resolved


def test_server_hedges_past_tracked_p99(db):
    text = MEMBERS_OF.format(uni="Univ0")
    plan = FaultPlan().slow_replica("r0", extra_s=0.6)

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, hedge=True,
            hedge_delay_ms=100.0, max_retries=1, max_batch=2,
            max_delay_ms=1.0, default_deadline_ms=10_000.0,
            watchdog_budget_ms=5_000.0,
        ) as server:
            for _ in range(6):
                await server.submit(text)  # disarmed warmup
            plan.arm()
            t0 = time.monotonic()
            results = [await server.submit(text) for _ in range(8)]
            elapsed = time.monotonic() - t0
            snap = server.metrics.snapshot()
        return results, snap, elapsed

    results, snap, elapsed = asyncio.run(go())
    assert all(r.ok for r in results)
    assert snap.hedges >= 1  # straggling attempts raced a duplicate
    # hedging means NOT paying the straggler's 0.6 s on every slow attempt
    assert elapsed < 0.6 * 8
    assert snap.submitted == snap.resolved


# --------------------------------------------------------------------- #
# property: exactly-once + oracle-identical under random fault schedules
# --------------------------------------------------------------------- #
def _run_schedule(seed, crash_batch, poison_every, slow_extra_ms, mutate):
    db = GraphDB(synth.lubm_like(n_universities=2, seed=0), device="cpu")
    plan = (
        FaultPlan(seed)
        .crash_replica("r0", at_batch=crash_batch)
        .poison_matching("Poison")
    )
    if slow_extra_ms:
        plan.slow_replica("r1", extra_s=slow_extra_ms / 1e3)
    rng = np.random.default_rng(seed)
    n = 24
    texts, poisoned = [], []
    for i in range(n):
        if poison_every and i % poison_every == 2:
            texts.append(MEMBERS_OF.format(uni=f"Poison{i}"))
            poisoned.append(True)
        else:
            uni = "Univ0" if rng.integers(2) == 0 else "Univ1"
            texts.append(MEMBERS_OF.format(uni=uni))
            poisoned.append(False)

    async def go():
        async with AsyncServer(
            db, replicas=2, fault_plan=plan, max_retries=2, max_batch=4,
            max_delay_ms=1.0, default_deadline_ms=30_000.0,
        ) as server:
            await asyncio.gather(
                *[server.submit(MEMBERS_OF.format(uni=u))
                  for u in ("Univ0", "Univ1")]
            )  # disarmed warmup
            plan.arm()
            futs = []
            for i, text in enumerate(texts):
                futs.append(server.submit(text))
                if mutate and i == n // 2:
                    db.insert([("DeptX", "subOrganizationOf", "Univ0")])
                    await server.fence()
                if i % 4 == 3:
                    await asyncio.sleep(0.002)  # let batches interleave
            results = await asyncio.gather(*futs)
            snap = server.metrics.snapshot()
        return results, snap

    results, snap = asyncio.run(go())
    # exactly once: every admitted submit resolved, with a legal outcome
    assert len(results) == n
    assert all(r.outcome in OUTCOMES for r in results)
    for text, is_poison, r in zip(texts, poisoned, results):
        if is_poison:
            assert r.outcome == "error"
            assert isinstance(r.error, InjectedPoison)
        else:
            assert r.ok, (text, r.outcome, r.detail)
            # bit-identical to the fault-free worklist oracle on the
            # snapshot the request was actually served against
            oracle = _oracle_mask(r.result.snapshot, text)
            assert np.array_equal(r.result.survivor_mask, oracle)
    # counters sum consistently after drain
    assert snap.submitted == snap.resolved
    assert snap.admitted == (
        snap.completed + snap.errors + snap.timeouts + snap.shed["deadline"]
    )


@settings(max_examples=5, deadline=None)
@given(
    seed=st.integers(0, 2**16),
    crash_batch=st.integers(1, 4),
    poison_every=st.sampled_from([0, 5, 8]),
    slow_extra_ms=st.sampled_from([0.0, 25.0]),
    mutate=st.booleans(),
)
def test_fault_schedules_exactly_once_property(
    seed, crash_batch, poison_every, slow_extra_ms, mutate
):
    _run_schedule(seed, crash_batch, poison_every, slow_extra_ms, mutate)


@pytest.mark.parametrize(
    "seed,crash_batch,poison_every,slow_extra_ms,mutate",
    [
        (7, 1, 5, 0.0, False),
        (11, 2, 8, 25.0, True),
        (23, 3, 0, 0.0, True),
    ],
)
def test_fault_schedules_exactly_once_fixed(
    seed, crash_batch, poison_every, slow_extra_ms, mutate
):
    # fixed-seed twin of the hypothesis property: runs in environments
    # without hypothesis installed (the CI [test] extra has it)
    _run_schedule(seed, crash_batch, poison_every, slow_extra_ms, mutate)
