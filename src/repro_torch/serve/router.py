"""Replica routing: N read replicas over immutable snapshots (DESIGN.md
Sect. 10.4), with a per-replica health plane (DESIGN.md Sect. 14.2).

Read replicas are nearly free in this system: a :class:`~repro_torch.db.
graphdb.GraphDB` hands out *immutable* graph snapshots, and plan-cache keys
carry the versioned fingerprint, so any number of :class:`~repro_torch.
engine.engine.Engine` instances can serve the same database concurrently
without coordination — each owns its plan cache, its adjacency uploads, and
its own lock, and ``Engine.execute_prepared`` pins exactly one snapshot per
batch.

What replicas add is *parallel service* on the host: replicas are threads
over one card, and every kernel launches on the current stream, which for
every replica thread is the card's legacy default stream — so device work
from all replicas serialises there, in launch order.  What overlaps is the
host side of a batch (SOI compile, operand builds, pruning in numpy, which
releases the GIL for its array loops) on one replica with the other
replica's kernels.  What replicas must not add is *torn reads*: a replica
adopting a mutation halfway through a batch.  Two mechanisms fence that:

* snapshot pinning — a batch refreshes at its start and never again, so
  every request in it sees one graph version (a mutation mid-batch lands in
  the *next* batch);
* mutation epochs — :meth:`ReplicaRouter.fence` refreshes every replica to
  the source's current version and returns that version; after a fence, no
  replica can serve a pre-mutation snapshot.

Routing itself is least-in-flight (ties broken round-robin) *weighted by
health*.  Raw least-in-flight has a failure-amplification bug: a replica
that fails fast drains its in-flight gauge fast, so the picker keeps
steering MORE traffic onto the broken member.  The router therefore keeps a
per-replica failure EWMA and a healthy → suspect → quarantined → rebuilding
state machine:

* attempt failures (the whole routed batch raised — a crash, not one bad
  request) and watchdog overruns mark a replica **suspect** and, after
  ``quarantine_after`` consecutive ones, **quarantined**;
* chronic stragglers are caught by the seed
  :class:`~repro_torch.distributed.fault.StragglerMonitor`, fed with cumulative
  service-time heartbeats so its step latency *is* the mean per-batch
  service time — a replica whose mean exceeds ``threshold × median`` of the
  fleet is straggling regardless of traffic shape;
* suspects keep serving but *probed*: the score penalty would otherwise
  starve a suspect of traffic entirely, so its failure streak could never
  reach the quarantine threshold (and a recovered replica could never
  prove itself) — every ``probe_every``-th route deliberately canaries a
  live batch onto a suspect, bounding a broken member's traffic share at
  ``1/probe_every`` while keeping its health verdict moving;
* quarantined replicas are skipped by :meth:`route` and **rebuilt** in the
  background under the seed :class:`~repro_torch.distributed.fault.RestartPolicy`:
  a fresh engine over the live ``GraphDB`` snapshot, refreshed to the
  current version, swapped in with a bumped *epoch* so late health reports
  from pre-rebuild attempts cannot poison the new engine (epoch-fenced
  re-admission).

Request-level faults (one poisoned query in a batch) are isolated per
request and do NOT count against the replica: poison travels with the
request and would fail anywhere.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

from repro_torch import spans
from repro_torch.db.results import ResultSet
from repro_torch.distributed.fault import Heartbeat, RestartPolicy, StragglerMonitor
from repro_torch.engine.engine import Engine

#: Replica health states (DESIGN.md 14.2).
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
REBUILDING = "rebuilding"

#: States a replica can be routed to.
ROUTABLE = (HEALTHY, SUSPECT)


class NoHealthyReplica(RuntimeError):
    """Every replica is quarantined or rebuilding: nothing to route to."""


@dataclasses.dataclass(frozen=True)
class BatchTrace:
    """What a traced attempt carries to its worker thread: the id of its
    ``serve.batch`` span, the riders' request ids in payload order, and the
    clock (:data:`repro_torch.spans.clock`) at the executor call."""

    span: int
    requests: tuple[int, ...]
    t_call: int


class Replica:
    """One read replica: a private engine, lock, gauges, and health state."""

    __slots__ = (
        "name", "engine", "lock", "in_flight", "batches",
        "state", "epoch", "error_score", "latency_ewma",
        "consecutive_failures", "consecutive_successes", "straggles",
        "service_clock", "hb_steps", "quarantines", "rebuilds", "last_error",
    )

    def __init__(self, name: str, engine: Engine):
        """Wrap ``engine`` as replica ``name`` in the healthy state."""
        self.name = name
        # `engine`/`lock` are swapped atomically by rebuild; users snapshot
        # both under the router lock and keep using their snapshot (a
        # pre-rebuild batch finishes on the old engine + old lock).
        self.engine = engine
        self.lock = threading.Lock()
        # Every gauge below belongs to the router's routing/health decision,
        # so all are guarded by the *router's* lock, not the engine lock.
        self.in_flight = 0  # guarded-by: self._route_lock
        self.batches = 0  # guarded-by: self._route_lock
        self.state = HEALTHY  # guarded-by: self._route_lock
        self.epoch = 0  # guarded-by: self._route_lock
        self.error_score = 0.0  # guarded-by: self._route_lock
        self.latency_ewma = None  # guarded-by: self._route_lock
        self.consecutive_failures = 0  # guarded-by: self._route_lock
        self.consecutive_successes = 0  # guarded-by: self._route_lock
        self.straggles = 0  # guarded-by: self._route_lock
        self.service_clock = 0.0  # guarded-by: self._route_lock
        self.hb_steps = 0  # guarded-by: self._route_lock
        self.quarantines = 0  # guarded-by: self._route_lock
        self.rebuilds = 0  # guarded-by: self._route_lock
        self.last_error = None  # guarded-by: self._route_lock


class ReplicaRouter:
    """Route prepared batches across N engine replicas of one database.

    Replicas inherit the database's engine configuration (engine
    preference, buckets, device, mesh and block count, incremental
    maintenance) so a routed request behaves exactly like ``db.query``
    modulo which plan cache warms up.
    When ``fault_plan`` is set, each replica engine gets the plan's bound
    request-level hooks and the router consults its replica-level hooks —
    all zero-cost no-ops while the plan is disarmed.
    """

    def __init__(
        self,
        db,
        n_replicas: int = 2,
        *,
        fault_plan=None,
        auto_rebuild: bool = True,
        suspect_after: int = 1,
        quarantine_after: int = 3,
        recover_after: int = 2,
        error_penalty: float = 4.0,
        suspect_penalty: float = 2.0,
        probe_every: int = 4,
        straggler_factor: float = 4.0,
        straggler_window: int = 8,
        rebuild_backoff_s: float = 0.05,
        max_rebuilds: int = 4,
    ):
        """Build ``n_replicas`` engines over ``db`` plus the health plane."""
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._db = db
        self._faults = fault_plan
        self.replicas = [
            Replica(f"r{i}", self._make_engine()) for i in range(n_replicas)
        ]
        if fault_plan is not None:
            for rep in self.replicas:
                rep.engine.faults = fault_plan.bind(rep.name)
        self._auto_rebuild = auto_rebuild
        self._suspect_after = max(1, suspect_after)
        self._quarantine_after = max(1, quarantine_after)
        self._recover_after = max(1, recover_after)
        self._error_penalty = error_penalty
        self._suspect_penalty = suspect_penalty
        self._probe_every = max(2, probe_every)
        self._restart_policy = RestartPolicy(
            max_restarts=max_rebuilds,
            backoff_s=rebuild_backoff_s,
            backoff_cap_s=1.0,
        )
        self._route_lock = threading.Lock()
        self._rr = 0  # guarded-by: _route_lock (round-robin tiebreaker)
        # service-time heartbeats: step = completed batches, t = cumulative
        # service seconds, so monitor "step latency" == mean service time
        self._monitor = StragglerMonitor(  # guarded-by: self._route_lock
            window=straggler_window, threshold=straggler_factor
        )
        self._events = []  # guarded-by: self._route_lock
        self._fence_failures = 0  # guarded-by: self._route_lock
        self._last_fence_partial = ()  # guarded-by: self._route_lock
        self._rebuild_threads = []  # guarded-by: self._route_lock

    def _make_engine(self) -> Engine:
        """A fresh engine replicating the database's own configuration."""
        proto = self._db._engine
        return Engine(
            self._db,
            engine=proto.engine_pref,
            cache_capacity=proto.cache.capacity,
            buckets=proto.buckets,
            device=proto.device,
            mesh=proto.mesh,
            n_blocks=proto.n_blocks,
            incremental=proto.incremental,
        )

    def __len__(self) -> int:
        """Number of replicas (routable or not)."""
        return len(self.replicas)

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    def route(self, exclude: Sequence[str] = ()) -> Replica:
        """Pick the best routable replica and count the batch in flight.

        Score is ``(in_flight + 1) · relative_latency + error_penalty ·
        failure_EWMA`` (+ a constant for suspects): expected wait in
        fleet-typical batch units, so a straggler saturates at one or two
        outstanding batches instead of matching the fast replicas'
        in-flight *count*, and a fast-failing replica is *de*-prioritized
        even though its in-flight gauge drains quickly.  Relative latency
        only bites at a >= 3x EWMA ratio — smaller disparities are host
        noise and must tie so the rotation keeps alternating.  Every
        ``probe_every``-th route canaries an *idle* suspect instead:
        without probes the penalty starves a suspect of traffic, so it
        can neither accumulate the failures that quarantine it nor the
        successes that recover it; requiring ``in_flight == 0`` bounds
        probe traffic to the suspect's own service rate.  ``exclude``
        names replicas already tried for this batch (retry/hedge
        placement); if exclusion empties the candidate set it is ignored —
        a busy replica beats no replica.  Raises
        :class:`NoHealthyReplica` when every replica is quarantined or
        rebuilding.
        """
        with self._route_lock:
            self._rr += 1
            avail = [r for r in self.replicas if r.state in ROUTABLE]
            if not avail:
                raise NoHealthyReplica(
                    "all replicas quarantined or rebuilding"
                )
            cands = [r for r in avail if r.name not in exclude] or avail
            if self._rr % self._probe_every == 0:
                # canary only *idle* suspects: a probe behind a backlog
                # re-measures the backlog, not the replica, and gating on
                # in_flight == 0 bounds probe traffic to the suspect's own
                # service rate (a wedged suspect drains via the watchdog,
                # a fast-failing one instantly, so probes keep flowing)
                suspects = [
                    r for r in cands
                    if r.state == SUSPECT and r.in_flight == 0
                ]
                if suspects:
                    rep = suspects[0]
                    rep.in_flight += 1
                    return rep
            k = self._rr % len(cands)
            order = cands[k:] + cands[:k]
            rep = min(order, key=self._score_locked)
            rep.in_flight += 1
            return rep

    # requires-lock: _route_lock
    def _score_locked(self, r: Replica) -> float:
        # Least-expected-wait, in units of fleet-typical batches: a batch
        # behind a 10x straggler waits 10x longer than its in_flight count
        # suggests, so in_flight alone keeps stacking work (and executor
        # slots) behind the slow replica until its *count* matches the
        # fast one's.  Scale by service latency relative to the fleet's
        # fastest (dimensionless, so the error/suspect penalties keep
        # their batch-count scale).  Sub-3x ratios score 1.0 — they are
        # noise, not signal: healthy replicas differ by EWMA epsilon (a
        # 2.8 ms vs 3.0 ms ratio is never exactly 1.0), and a loaded
        # host shows 2x between *identical* replicas; under a strict
        # min() any such epsilon steers 100% of idle-time traffic to one
        # replica, and with a sequential client the starved replica's
        # stale EWMA never gets a correcting sample — the bias is
        # permanent.  Only order-of-magnitude disparities (an actual
        # straggler) steer; near-equals must tie exactly so the rotation
        # alternates.  Unknown latency scores as 1.0: a fresh replica is
        # not presumed slow.
        lats = [
            x.latency_ewma for x in self.replicas
            if x.latency_ewma is not None and x.latency_ewma > 0.0
        ]
        slowness = 1.0
        if lats and r.latency_ewma is not None and r.latency_ewma > 0.0:
            ratio = r.latency_ewma / max(min(lats), 1e-9)
            if ratio >= 3.0:
                slowness = round(ratio)
        score = (r.in_flight + 1.0) * slowness
        score += self._error_penalty * r.error_score
        if r.state == SUSPECT:
            score += self._suspect_penalty
        return score

    def release(self, rep: Replica) -> None:
        """Return a routed batch slot."""
        with self._route_lock:
            rep.in_flight -= 1
            rep.batches += 1

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def execute_isolated(
        self, prepared: Sequence
    ) -> tuple[list[ResultSet | Exception], str]:
        """Route one prepared batch and execute it (route + execute_on)."""
        rep = self.route()
        return self.execute_on(rep, prepared)

    def execute_on(
        self, rep: Replica, prepared: Sequence, trace: BatchTrace | None = None
    ) -> tuple[list[ResultSet | Exception], str]:
        """Execute one prepared batch on an already-routed replica.

        Returns ``(outcomes, replica_name)`` where each outcome is either a
        :class:`ResultSet` or the exception *that request* raised.  The
        fast path executes the whole batch in one microbatched call; if it
        raises, the batch re-runs request-by-request so one poisoned
        request cannot take its siblings' results down with it (the same
        isolation contract as ``Session.flush``).

        An exception escaping this method is an *attempt* failure (the
        replica itself broke — e.g. an injected crash) and feeds the health
        plane; per-request outcome exceptions do not.  Health reports are
        epoch-fenced: a batch that started before a rebuild cannot mark the
        rebuilt engine.  The routed slot is always released.

        With ``trace``, the wait from the executor call to the replica's
        lock is a ``serve.replica_wait`` span, and the engine's spans are
        children of the attempt's ``serve.batch`` span.
        """
        span, rids = (trace.span, trace.requests) if trace is not None else (None, None)
        with self._route_lock:
            eng = rep.engine
            lk = rep.lock
            epoch = rep.epoch
        t0 = time.monotonic()
        try:
            if self._faults is not None:
                self._faults.on_batch_start(rep.name)
            with lk:
                if trace is not None:
                    spans.record("serve.replica_wait", trace.t_call, spans.clock(),
                                 parent=span, replica=rep.name)
                # the slow-fault penalty scales *solve* time only: clocking
                # it from before the lock would multiply each batch's wait
                # behind its predecessor's sleep — an exponential backlog
                # no real 10x-slower replica exhibits
                t_solve = time.monotonic()
                try:
                    with spans.inside(span, rids):
                        raws = eng.execute_prepared(list(prepared))
                    snap = eng.db
                    out: list[ResultSet | Exception] = [
                        ResultSet(r, snap) for r in raws
                    ]
                except Exception:
                    out = []
                    for i, pr in enumerate(prepared):
                        try:
                            with spans.inside(span, None if rids is None else rids[i:i + 1]):
                                raw = eng.execute_prepared([pr])[0]
                            out.append(ResultSet(raw, eng.db))
                        except Exception as exc:  # this request's own fault
                            out.append(exc)
                if self._faults is not None:
                    penalty = self._faults.solve_penalty(
                        rep.name, time.monotonic() - t_solve
                    )
                    if penalty > 0.0:
                        time.sleep(penalty)
        except BaseException as exc:
            self._observe(rep, epoch, time.monotonic() - t0, error=exc)
            raise
        else:
            self._observe(rep, epoch, time.monotonic() - t0, error=None)
            return out, rep.name
        finally:
            self.release(rep)

    def on_overrun(self, rep: Replica) -> None:
        """Record a watchdog overrun: the routed attempt was abandoned."""
        with self._route_lock:
            if rep.state in (QUARANTINED, REBUILDING):
                return
            self._note_failure_locked(rep, "solve watchdog overrun")

    # ------------------------------------------------------------------ #
    # health plane
    # ------------------------------------------------------------------ #
    def _observe(
        self, rep: Replica, epoch: int, dt: float, *, error
    ) -> None:
        """Feed one finished attempt into the health state machine."""
        with self._route_lock:
            if rep.epoch != epoch:
                return  # pre-rebuild attempt: not the new engine's record
            if rep.state in (QUARANTINED, REBUILDING):
                return
            if error is not None:
                self._note_failure_locked(rep, repr(error))
                return
            # success: latency + straggler bookkeeping (failures are often
            # artificially fast, so only successes move the latency view)
            rep.error_score *= 0.5
            rep.consecutive_failures = 0
            prev = rep.latency_ewma
            rep.latency_ewma = dt if prev is None else 0.8 * prev + 0.2 * dt
            rep.service_clock += dt
            rep.hb_steps += 1
            self._monitor.report(
                Heartbeat(rep.name, rep.hb_steps, rep.service_clock)
            )
            if rep.name in self._monitor.stragglers():
                rep.straggles += 1
                rep.consecutive_successes = 0
                if rep.straggles >= self._quarantine_after:
                    self._quarantine_locked(rep, "chronic straggler")
                elif (
                    rep.state == HEALTHY
                    and rep.straggles >= self._suspect_after
                ):
                    rep.state = SUSPECT
                    self._event_locked(rep, "suspect", "straggling")
            else:
                rep.straggles = 0
                rep.consecutive_successes += 1
                if rep.consecutive_successes >= self._recover_after:
                    # full recovery clears the penalty entirely — the EWMA
                    # is evidence for state transitions, not a permanent
                    # tax.  A lingering epsilon would deterministically
                    # lose every min() tie-break under light sequential
                    # load, starving this replica of the traffic that
                    # warms its plan cache (and of the successes that
                    # would ever decay the epsilon away).
                    rep.error_score = 0.0
                    if rep.state == SUSPECT:
                        rep.state = HEALTHY
                        self._event_locked(rep, "recovered", "")

    # requires-lock: _route_lock
    def _note_failure_locked(self, rep: Replica, reason: str) -> None:
        rep.error_score = 0.5 * rep.error_score + 0.5
        rep.consecutive_failures += 1
        rep.consecutive_successes = 0
        rep.last_error = reason
        if rep.consecutive_failures >= self._quarantine_after:
            self._quarantine_locked(rep, reason)
        elif rep.state == HEALTHY and (
            rep.consecutive_failures >= self._suspect_after
        ):
            rep.state = SUSPECT
            self._event_locked(rep, "suspect", reason)

    # requires-lock: _route_lock
    def _quarantine_locked(self, rep: Replica, reason: str) -> None:
        if rep.state in (QUARANTINED, REBUILDING):
            return
        others = [
            r for r in self.replicas
            if r is not rep and r.state in ROUTABLE
        ]
        if not others:
            # never quarantine the last routable replica: degraded service
            # beats no service (stays suspect, keeps its error penalty)
            rep.state = SUSPECT
            self._event_locked(rep, "quarantine_deferred", reason)
            return
        rep.state = QUARANTINED
        rep.quarantines += 1
        self._event_locked(rep, "quarantined", reason)
        if self._auto_rebuild:
            t = threading.Thread(
                target=self._rebuild, args=(rep,),
                name=f"rebuild-{rep.name}", daemon=True,
            )
            self._rebuild_threads.append(t)
            t.start()

    def _rebuild(self, rep: Replica) -> None:
        """Background rebuild of a quarantined replica (epoch-fenced swap).

        Runs under the seed :class:`RestartPolicy` (capped exponential
        backoff, bounded restarts).  A rebuild is the moral equivalent of a
        process restart, so the fault plan's crash state for this replica
        is healed first; the fresh engine is built from the live database,
        refreshed to its current version, then swapped in together with a
        NEW replica lock — the old lock may be held forever by a wedged
        abandoned attempt — and a bumped epoch so stale health reports are
        fenced out.
        """
        if self._faults is not None:
            self._faults.heal(rep.name)

        def body(_restart_idx: int) -> None:
            with self._route_lock:
                rep.state = REBUILDING
                self._event_locked(rep, "rebuilding", "")
            eng = self._make_engine()
            if self._faults is not None:
                eng.faults = self._faults.bind(rep.name)
            eng.refresh()
            with self._route_lock:
                rep.engine = eng
                rep.lock = threading.Lock()
                rep.epoch += 1
                rep.state = HEALTHY
                rep.rebuilds += 1
                rep.error_score = 0.0
                rep.latency_ewma = None
                rep.consecutive_failures = 0
                rep.consecutive_successes = 0
                rep.straggles = 0
                rep.service_clock = 0.0
                rep.hb_steps = 0
                self._monitor.forget(rep.name)
                self._event_locked(rep, "rebuilt", f"epoch {rep.epoch}")

        try:
            self._restart_policy.run(body, sleep=time.sleep)
        except BaseException as exc:  # noqa: BLE001 — supervisor semantics
            with self._route_lock:
                rep.state = QUARANTINED
                rep.last_error = f"rebuild failed: {exc!r}"
                self._event_locked(rep, "rebuild_failed", repr(exc))

    # requires-lock: _route_lock
    def _event_locked(self, rep: Replica, event: str, detail: str) -> None:
        self._events.append({
            "t": time.monotonic(),
            "replica": rep.name,
            "event": event,
            "detail": detail,
            "batches": rep.batches,
        })

    def health(self) -> list[dict]:
        """Per-replica health snapshot (state, scores, epochs, gauges)."""
        with self._route_lock:
            return [
                {
                    "name": r.name,
                    "state": r.state,
                    "epoch": r.epoch,
                    "in_flight": r.in_flight,
                    "batches": r.batches,
                    "error_score": round(r.error_score, 4),
                    "latency_ewma_ms": (
                        None if r.latency_ewma is None
                        else round(r.latency_ewma * 1e3, 3)
                    ),
                    "quarantines": r.quarantines,
                    "rebuilds": r.rebuilds,
                    "last_error": r.last_error,
                }
                for r in self.replicas
            ]

    def events(self) -> list[dict]:
        """Health transition log (suspect/quarantined/rebuilt/...)."""
        with self._route_lock:
            return [dict(e) for e in self._events]

    def wait_rebuilt(self, timeout: float = 5.0) -> bool:
        """Block until no replica is quarantined/rebuilding (True on success)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._route_lock:
                bad = [
                    r for r in self.replicas
                    if r.state in (QUARANTINED, REBUILDING)
                ]
            if not bad:
                return True
            time.sleep(0.01)
        return False

    # ------------------------------------------------------------------ #
    def fence(self) -> int:
        """Advance every replica to the source's current mutation epoch.

        Returns the fenced version: after this call no *successfully
        fenced* replica will serve a snapshot older than it (reads started
        before the fence keep their pinned — complete, never half-applied —
        older snapshot).  A replica whose ``refresh()`` raises no longer
        aborts the fleet fence half-way: it is marked suspect, the
        remaining replicas are still fenced, and the partial fence is
        reported via :meth:`aggregate` / ``last_fence_partial``.
        """
        version = self._db.version
        failed: list[str] = []
        for rep in self.replicas:
            with self._route_lock:
                eng = rep.engine
                lk = rep.lock
            try:
                if self._faults is not None:
                    self._faults.on_refresh(rep.name)
                with lk:
                    eng.refresh()
            except Exception as exc:
                failed.append(rep.name)
                with self._route_lock:
                    self._fence_failures += 1
                    self._note_failure_locked(
                        rep, f"fence refresh failed: {exc!r}"
                    )
        with self._route_lock:
            self._last_fence_partial = tuple(failed)
        return version

    def versions(self) -> list[int | None]:
        """Each replica's currently-adopted source version (for tests)."""
        out: list[int | None] = []
        for rep in self.replicas:
            with rep.lock:  # RL3: fence() mutates the engine under rep.lock
                out.append(rep.engine._version)
        return out

    def stats(self) -> list:
        """Per-replica :class:`~repro_torch.engine.engine.EngineMetrics`."""
        return [rep.engine.stats() for rep in self.replicas]

    def aggregate(self) -> dict[str, int | float]:
        """Summed serving counters across replicas (the CLI's one-liner)."""
        agg = {
            "requests": 0, "microbatches": 0, "cache_hits": 0,
            "cache_misses": 0, "plan_builds": 0, "plan_invalidations": 0,
            "plans_resumable": 0, "plans_resumed": 0, "warm_resume_solves": 0,
            "resumes_declined": 0, "adj_rebuilds_saved": 0,
        }
        engines: dict[str, int] = {}
        for m in self.stats():
            agg["requests"] += m.requests
            agg["microbatches"] += m.microbatches
            agg["cache_hits"] += m.cache.hits
            agg["cache_misses"] += m.cache.misses
            agg["plan_builds"] += m.plan_builds
            agg["plan_invalidations"] += m.plan_invalidations
            agg["plans_resumable"] += m.plans_resumable
            agg["plans_resumed"] += m.plans_resumed
            agg["warm_resume_solves"] += m.warm_resume_solves
            agg["resumes_declined"] += m.resumes_declined
            agg["adj_rebuilds_saved"] += m.adj_rebuilds_saved
            for eng, cnt in m.engine_counts.items():
                engines[eng] = engines.get(eng, 0) + cnt
        agg["engine_counts"] = engines
        with self._route_lock:  # RL3: `batches` is mutated under _route_lock
            agg["batches_per_replica"] = [r.batches for r in self.replicas]
            agg["health"] = {r.name: r.state for r in self.replicas}
            agg["quarantines"] = sum(r.quarantines for r in self.replicas)
            agg["rebuilds"] = sum(r.rebuilds for r in self.replicas)
            agg["fence_failures"] = self._fence_failures
            agg["fence_partial"] = list(self._last_fence_partial)
        return agg
