"""Admission-controlled asyncio serving loop (DESIGN.md Sect. 10).

The paper positions dual simulation as a pre-filter *inside a database
system serving real traffic*; Pérez et al. put the worst case of that
traffic at Pspace-complete, so a production front end must bound what it
accepts — unbounded queueing turns one pathological template into
everyone's latency.  :class:`AsyncServer` is that front end over the stable
``repro_torch.db`` surface:

* **admission control** — a bounded queue (``max_queue``), a per-request
  model-cost cap (``cost_cap``, priced by :func:`repro_torch.engine.
  cost.admission_estimate`), and per-request deadlines.  A request that cannot
  be admitted is *shed immediately* with an explicit outcome
  (``overloaded`` / ``cost`` / ``deadline``) instead of queueing without
  bound — the backpressure contract is "a fast no, never a slow maybe".
* **per-tenant fairness** — admitted requests enter a deficit-round-robin
  scheduler (:mod:`repro_torch.serve.fairness`); a template storm from one
  tenant cannot starve the others' dispatch slots.
* **replica routing** — batches execute on a pool of engine replicas over
  immutable snapshots (:mod:`repro_torch.serve.router`), overlapping service.
* **real flush timer** — the dispatcher releases a batch when it fills
  (``max_batch``) or when the oldest admitted request has waited
  ``max_delay_ms``, whichever first; unlike the cooperative
  :class:`~repro_torch.db.session.Session` policy this timer fires without any
  further submit arriving.
* **streaming delivery** — :func:`stream_pages` paginates a result set as
  an async iterator, so a large survivor set never materializes in one
  response.
* **failure handling** (DESIGN.md Sect. 14) — a transient batch failure is
  retried on a *different* replica while the riders' deadlines still
  afford it (the retry decision is ``remaining_budget > estimated_cost``,
  priced by the calibrated cost model, with capped exponential backoff); a
  per-batch **solve watchdog** bounds each routed attempt's wall clock and
  abandons overruns (the replica goes suspect, the batch retries once on a
  healthy one, then resolves with the explicit ``timeout`` outcome); and
  optional **hedging** races a duplicate dispatch once an attempt's
  service time passes the tracked p99.  Deterministic fault injection
  (:mod:`repro_torch.faults`) drives all of it in tests; the hooks are no-ops
  when no plan is armed.

Every submitted request resolves to a :class:`ServeResult`; the server
never leaves a future unresolved, including through :meth:`AsyncServer.
stop` (queued work is drained) and including an executor that rejects the
batch outright.  All submissions must happen on the event loop that
started the server; execution happens on a thread pool slightly wider than
the replica count (abandoned attempts may linger on a worker), and
mutations go through the shared ``GraphDB`` exactly as before — the server
is a pure front end.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator

from repro_torch import spans
from repro_torch.db.results import ResultSet
from repro_torch.engine import cost as cost_mod

from .fairness import DeficitRoundRobin
from .metrics import ServeMetrics
from .router import BatchTrace, NoHealthyReplica, ReplicaRouter

#: ServeResult.outcome values: exactly one per submitted request.
OUTCOMES = ("ok", "overloaded", "cost", "deadline", "error", "timeout")


def _consume_exception(fut) -> None:
    """Mark an (possibly abandoned) attempt future's exception as retrieved."""
    if not fut.cancelled():
        fut.exception()


def _wait_timeout(budget: float) -> float | None:
    """Convert an infinite watchdog budget to asyncio's no-timeout form."""
    return None if math.isinf(budget) else budget


@dataclasses.dataclass
class ServeResult:
    """Terminal outcome of one submitted request.

    ``outcome`` is one of :data:`OUTCOMES`; ``result`` is set iff the
    outcome is ``"ok"``.  ``queue_ms`` is admission-to-dispatch wait,
    ``service_ms`` the wall time of the microbatch the request rode in
    (a batch property, shared by its riders — the per-request fair share
    lives in ``result.timings``), ``total_ms`` submit-to-resolution.
    """

    outcome: str
    tenant: str
    result: ResultSet | None = None
    error: Exception | None = None
    detail: str = ""
    queue_ms: float = 0.0
    service_ms: float = 0.0
    total_ms: float = 0.0
    replica: str | None = None

    @property
    def ok(self) -> bool:
        """True iff the request completed with a result."""
        return self.outcome == "ok"


class _Pending:
    """One admitted request waiting in the fair scheduler."""

    __slots__ = ("prepared", "tenant", "t_submit", "deadline", "future",
                 "rid", "span", "t_ns")

    def __init__(self, prepared, tenant, t_submit, deadline, future,
                 rid, span, t_ns):
        self.prepared = prepared
        self.tenant = tenant
        self.t_submit = t_submit
        self.deadline = deadline
        self.future = future
        self.rid = rid  # the request id, assigned at submit
        self.span = span  # its serve.request span id; None untraced
        self.t_ns = t_ns  # submit on the spans' clock (traced only)


class AsyncServer:
    """Admission-controlled, tenant-fair, replicated serving loop.

    Usage::

        async with AsyncServer(db, replicas=2, max_queue=64) as server:
            results = await asyncio.gather(
                *[server.submit(q, tenant="alice") for q in queries]
            )

    Parameters: ``replicas`` engine replicas (thread-pool width);
    ``max_queue`` bounds admitted-but-undispatched requests; ``max_batch``
    caps one dispatch (default: the engine's largest microbatch bucket);
    ``max_delay_ms`` is the real flush timer; ``default_deadline_ms``
    bounds queue wait per request (a request older than its deadline at
    dispatch time is shed, never executed); ``cost_cap`` rejects requests
    whose :func:`~repro_torch.engine.cost.admission_estimate` exceeds it;
    ``tenant_weights``/``quantum`` configure the fair scheduler.

    Failure-plane knobs (DESIGN.md Sect. 14): ``max_retries`` caps extra
    attempts per batch (each on a replica not yet tried); ``retry_backoff_
    ms`` is the first backoff, doubling per retry up to ``retry_backoff_
    cap_ms``; ``watchdog_factor``/``watchdog_min_ms`` price an attempt's
    wall-clock budget off the cost estimate and the tracked service p99
    (no signal → no watchdog), or ``watchdog_budget_ms`` pins the budget
    outright; ``hedge`` enables speculative duplicate dispatch after
    ``hedge_factor`` × the service p99 (or a pinned ``hedge_delay_ms``);
    ``fault_plan`` attaches a :class:`repro_torch.faults.FaultPlan` (hooks stay
    no-ops until it is armed).
    """

    def __init__(
        self,
        db,
        *,
        replicas: int = 2,
        max_queue: int = 256,
        max_batch: int | None = None,
        max_delay_ms: float = 2.0,
        default_deadline_ms: float = 1000.0,
        cost_cap: float | None = None,
        tenant_weights: dict[str, float] | None = None,
        quantum: float = 4.0,
        fault_plan=None,
        max_retries: int = 1,
        retry_backoff_ms: float = 5.0,
        retry_backoff_cap_ms: float = 80.0,
        watchdog_factor: float = 8.0,
        watchdog_min_ms: float = 250.0,
        watchdog_budget_ms: float | None = None,
        hedge: bool = False,
        hedge_factor: float = 3.0,
        hedge_delay_ms: float | None = None,
    ):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._db = db
        self.max_queue = max_queue
        self.max_batch = (
            max_batch if max_batch is not None else max(db._engine.buckets)
        )
        self.max_delay = max_delay_ms / 1e3
        self.default_deadline = default_deadline_ms / 1e3
        self.cost_cap = cost_cap
        self.max_retries = max(0, max_retries)
        self.retry_backoff = retry_backoff_ms / 1e3
        self.retry_backoff_cap = retry_backoff_cap_ms / 1e3
        self.watchdog_factor = watchdog_factor
        self.watchdog_min = watchdog_min_ms / 1e3
        self.watchdog_budget = (
            None if watchdog_budget_ms is None else watchdog_budget_ms / 1e3
        )
        self.hedge = hedge
        self.hedge_factor = hedge_factor
        self.hedge_delay = (
            None if hedge_delay_ms is None else hedge_delay_ms / 1e3
        )
        self._faults = fault_plan
        self.router = ReplicaRouter(db, replicas, fault_plan=fault_plan)
        self.metrics = ServeMetrics()
        self._scheduler = DeficitRoundRobin(
            quantum=quantum, weights=tenant_weights
        )
        # Sized for the worst concurrent attempt fan-out, not just the
        # replica count: each of the <= replicas live batches (dispatch
        # permits) can have one running attempt, up to max_retries
        # watchdog-abandoned attempts still draining on their threads, and
        # one hedge.  An undersized pool turns one wedged replica into
        # fleet-wide starvation — freshly dispatched batches sit in the
        # *pool* queue past the watchdog, and the overrun is then blamed
        # on a replica that never saw the batch.
        self._pool = ThreadPoolExecutor(
            max_workers=replicas * (self.max_retries + 2) + 2,
            thread_name_prefix="repro-torch-serve",
        )
        self._cost_memo: dict[str, float] = {}  # template key -> admission cost
        self._request_ids = itertools.count(1)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._wake: asyncio.Event | None = None
        self._sem: asyncio.Semaphore | None = None
        self._dispatcher: asyncio.Task | None = None
        self._batch_tasks: set[asyncio.Task] = set()
        self._running = False
        self._stopping = False

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    async def start(self) -> "AsyncServer":
        """Bind to the running loop and start the dispatcher task."""
        if self._running:
            raise RuntimeError("server already started")
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._sem = asyncio.Semaphore(len(self.router))
        self._running = True
        self._stopping = False
        self._dispatcher = self._loop.create_task(self._dispatch_loop())
        return self

    async def stop(self) -> None:
        """Drain queued work, resolve every future, and shut down.

        The backpressure contract survives shutdown: nothing admitted is
        ever left unresolved (drained requests still honor deadlines).
        """
        if not self._running:
            return
        self._stopping = True
        self._running = False
        self._wake.set()
        await self._dispatcher
        if self._batch_tasks:
            await asyncio.gather(*self._batch_tasks)
        self._pool.shutdown(wait=True)

    async def __aenter__(self) -> "AsyncServer":
        return await self.start()

    async def __aexit__(self, exc_type, exc, tb) -> None:
        await self.stop()

    async def fence(self) -> int:
        """Advance every replica past the latest mutation epoch.

        Off-loop (replica locks may be held by in-flight batches).
        Returns the fenced version; see :meth:`ReplicaRouter.fence`.
        """
        return await self._loop.run_in_executor(self._pool, self.router.fence)

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def submit(
        self,
        query,
        *,
        tenant: str = "default",
        deadline_ms: float | None = None,
    ) -> "asyncio.Future[ServeResult]":
        """Admit or shed one request; returns a future of its outcome.

        Synchronous on purpose: admission is the *cheap* path (parse +
        canonicalize + O(1) checks) and must answer immediately — a shed
        request's future is already resolved when this returns.  Must be
        called on the server's event loop.  ``query`` may be text, a
        parsed query, or a ``Q`` builder.

        Each request gets an id here.  While tracing
        (:mod:`repro_torch.spans`), it is a ``serve.request`` span from here
        to its outcome, parent of its ``parse`` span (its wait in the queue is
        ``ServeResult.queue_ms``).
        """
        if not self._running:
            raise RuntimeError("server is not running")
        fut: asyncio.Future[ServeResult] = self._loop.create_future()
        now = time.monotonic()
        rid = next(self._request_ids)
        span = spans.new_id()
        t_ns = spans.clock() if span is not None else 0
        self.metrics.on_submit(tenant)

        def shed(res: ServeResult) -> asyncio.Future[ServeResult]:
            if span is not None:
                spans.record("serve.request", t_ns, spans.clock(), id=span,
                             request=rid, tenant=tenant, outcome=res.outcome)
            fut.set_result(res)
            return fut

        # gate 1: bounded queue — shed instead of queueing without bound
        if len(self._scheduler) >= self.max_queue:
            self.metrics.on_shed(tenant, "overloaded")
            return shed(ServeResult(
                outcome="overloaded", tenant=tenant,
                detail=f"queue full ({self.max_queue})",
            ))

        # parse + canonicalize once; syntax errors are the *request's*
        # fault and resolve its own future, they never enter the queue
        try:
            with spans.inside(span, (rid,)):
                prepared = self._db._engine.prepare(self._db._coerce(query))
        except Exception as exc:
            self.metrics.on_error(tenant)
            return shed(ServeResult(
                outcome="error", tenant=tenant, error=exc,
                detail="rejected at parse",
            ))

        # gate 2: model-cost cap (Pspace-complete worst cases stay out)
        if self.cost_cap is not None:
            est = self._admission_cost(prepared[0])
            if est > self.cost_cap:
                self.metrics.on_shed(tenant, "cost")
                return shed(ServeResult(
                    outcome="cost", tenant=tenant,
                    detail=f"estimated cost {est:.3g} > cap {self.cost_cap:.3g}",
                ))

        # gate 3: deadline already unmeetable
        deadline_s = (
            deadline_ms if deadline_ms is not None else self.default_deadline * 1e3
        ) / 1e3
        if deadline_s <= 0:
            self.metrics.on_shed(tenant, "deadline")
            return shed(ServeResult(
                outcome="deadline", tenant=tenant, detail="expired at admission",
            ))

        item = _Pending(prepared, tenant, now, now + deadline_s, fut, rid, span, t_ns)
        depth = self._scheduler.enqueue(tenant, item)
        self.metrics.on_admit(depth)
        self._wake.set()
        return fut

    def _admission_cost(self, query) -> float:
        """Memoized :func:`~repro_torch.engine.cost.admission_estimate` per query.

        Memoized on the query text (template keys collapse constants, but
        the estimate is constant-independent anyway); the memo resets when
        the graph mutates, since the estimate prices the current snapshot.
        """
        key = f"v{self._db.version}:{query!r}"
        est = self._cost_memo.get(key)
        if est is None:
            if len(self._cost_memo) > 4096:
                self._cost_memo.clear()
            # priced with the engine's machine calibration (DESIGN.md 13):
            # with a MachineSpec the estimate is seconds of sparse-engine
            # solve time, so cost_cap becomes a latency budget
            est = cost_mod.admission_estimate(
                self._db.graph, query,
                spec=getattr(self._db._engine, "spec", None),
            )
            self._cost_memo[key] = est
        return est

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        """Admitted requests not yet dispatched."""
        return len(self._scheduler)

    async def _dispatch_loop(self) -> None:
        """Single dispatcher: batch release policy + fair draining.

        Releases a batch when it can fill ``max_batch``, when the oldest
        admitted request has waited ``max_delay``, or on shutdown drain.
        Runs as the only consumer of the scheduler, so the scheduler needs
        no lock (submissions happen on the same loop).
        """
        while True:
            depth = len(self._scheduler)
            if depth == 0:
                if self._stopping:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            oldest = min(p.t_submit for p in self._scheduler.heads())
            age = time.monotonic() - oldest
            if depth >= self.max_batch or age >= self.max_delay or self._stopping:
                await self._sem.acquire()
                batch = self._scheduler.take(self.max_batch)
                self.metrics.set_queue_depth(len(self._scheduler))
                task = self._loop.create_task(self._run_batch(batch))
                self._batch_tasks.add(task)
                task.add_done_callback(self._batch_tasks.discard)
            else:
                self._wake.clear()
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), timeout=self.max_delay - age
                    )
                except asyncio.TimeoutError:
                    pass  # flush timer fired: release the partial batch

    async def _run_batch(self, batch) -> None:
        """Execute one fair-share batch; every rider resolves, no matter what.

        The outer except is the unresolved-future fix:
        if anything in the serve path itself raises — the executor
        rejecting work after shutdown, routing failing, a bug — every
        still-pending rider resolves with ``outcome="error"`` instead of
        being leaked when the task dies.
        """
        live: list[_Pending] = []
        try:
            now = time.monotonic()
            for tenant, p in batch:  # rl4: track=p
                if now > p.deadline:
                    # admitted but queued past its deadline: shed at
                    # dispatch, never executed — this is what bounds the
                    # tail latency of everything we *do* execute
                    self._finish(p, ServeResult(
                        outcome="deadline", tenant=tenant,
                        detail="deadline exceeded in queue",
                        queue_ms=(now - p.t_submit) * 1e3,
                        total_ms=(now - p.t_submit) * 1e3,
                    ))
                else:
                    live.append(p)
            if live:
                await self._serve_batch(live)
        except Exception as exc:
            self._fail_all(live, exc, "serve path failure")
        finally:
            self._sem.release()

    async def _serve_batch(self, live: list[_Pending]) -> None:
        """Deadline-budgeted attempt loop: route, watch, retry, hedge.

        Each attempt runs on a replica not yet tried for this batch, under
        a watchdog budget (:meth:`_watchdog_budget`).  A failed attempt
        retries while ``remaining_budget > estimated_cost + backoff`` and
        attempts remain; a watchdog overrun marks the replica suspect and
        retries on a healthy one; riders whose own deadline lapses during
        the attempts resolve with the explicit ``timeout`` outcome.
        """
        tried: set[str] = set()
        attempt = 0
        backoff = self.retry_backoff
        while True:
            now = time.monotonic()
            still: list[_Pending] = []
            for p in live:  # rl4: track=p
                if now >= p.deadline:
                    # budget exhausted riding failed attempts (or, on the
                    # first attempt, while this coroutine was scheduled)
                    self._finish(p, ServeResult(
                        outcome="timeout" if attempt else "deadline",
                        tenant=p.tenant,
                        detail=f"deadline exhausted after {attempt} attempt(s)",
                        queue_ms=0.0,
                        total_ms=(now - p.t_submit) * 1e3,
                    ))
                else:
                    still.append(p)
            live = still
            if not live:
                return
            attempt += 1
            remaining = min(p.deadline for p in live) - now
            try:
                rep = self.router.route(exclude=tried)
            except NoHealthyReplica as exc:
                self._fail_all(live, exc, "no healthy replica")
                return
            payload = [p.prepared for p in live]
            trace = None
            if spans.enabled():
                trace = BatchTrace(spans.new_id(), tuple(p.rid for p in live), spans.clock())
            try:
                if self._faults is not None:
                    self._faults.on_dispatch()
                exec_fut = self._loop.run_in_executor(
                    self._pool, self.router.execute_on, rep, payload, trace
                )
            except Exception as exc:
                # the executor itself rejected the batch (pool shut down,
                # injected reject): execute_on never ran, release here
                self.router.release(rep)
                self._fail_all(live, exc, "executor rejected the batch")
                return
            exec_fut.add_done_callback(_consume_exception)
            watchdog = self._watchdog_budget(live, remaining)
            t0 = time.monotonic()
            try:
                try:
                    outcomes, replica = await self._await_attempt(
                        exec_fut, rep, tried, payload, watchdog, trace
                    )
                finally:
                    if trace is not None:
                        spans.record("serve.batch", trace.t_call, spans.clock(),
                                     id=trace.span, requests=list(trace.requests),
                                     replica=rep.name, attempt=attempt)
            except asyncio.TimeoutError:
                # watchdog overrun: abandon the routed attempt (its thread
                # finishes in the background; health reports from it are
                # epoch-fenced), mark the replica suspect, retry elsewhere
                self.router.on_overrun(rep)
                self.metrics.on_watchdog()
                tried.add(rep.name)
                if attempt > self.max_retries:
                    self._timeout_all(
                        live,
                        f"solve watchdog fired after {watchdog * 1e3:.0f} ms; "
                        "retries exhausted",
                    )
                    return
                self.metrics.on_retry()
                continue
            except Exception as exc:
                tried.add(rep.name)
                budget = min(p.deadline for p in live) - time.monotonic()
                price = self._retry_price(live)
                if attempt > self.max_retries:
                    self._fail_all(live, exc, "retries exhausted")
                    return
                if budget <= price + backoff:
                    # the calibrated estimate says a retry cannot finish
                    # inside the riders' deadlines: fail fast instead of
                    # burning a replica slot on a doomed attempt
                    self._fail_all(live, exc, "no deadline budget for a retry")
                    return
                self.metrics.on_retry()
                await asyncio.sleep(min(backoff, budget))
                backoff = min(backoff * 2.0, self.retry_backoff_cap)
                continue
            t1 = time.monotonic()
            service_ms = (t1 - t0) * 1e3
            self.metrics.on_batch(t1 - t0, len(self._scheduler))
            for p, out in zip(live, outcomes):  # rl4: track=p
                queue_s = t0 - p.t_submit
                total_s = t1 - p.t_submit
                if isinstance(out, Exception):
                    self._finish(p, ServeResult(
                        outcome="error", tenant=p.tenant, error=out,
                        queue_ms=queue_s * 1e3, service_ms=service_ms,
                        total_ms=total_s * 1e3, replica=replica,
                    ))
                else:
                    self._finish(p, ServeResult(
                        outcome="ok", tenant=p.tenant, result=out,
                        queue_ms=queue_s * 1e3, service_ms=service_ms,
                        total_ms=total_s * 1e3, replica=replica,
                    ))
            return

    async def _await_attempt(self, exec_fut, rep, tried, payload, watchdog, trace):
        """Await one routed attempt under its watchdog, hedging if enabled.

        Never cancels the executor future — a running solve cannot be
        interrupted; on overrun it is *abandoned* (``asyncio.wait``, not
        ``wait_for``, precisely so the watchdog fires on time instead of
        blocking until the wedged thread finishes) and
        :exc:`asyncio.TimeoutError` is raised for the caller's retry path.
        With hedging on and a tracked service p99, a secondary dispatch
        races the primary once it runs ``hedge_factor`` × p99 late; the
        first clean completion wins (reads are idempotent — duplicate
        execution is safe).
        """
        hedge_delay = self._hedge_delay() if self.hedge else None
        if hedge_delay is None or hedge_delay >= watchdog:
            done, _ = await asyncio.wait(
                {exec_fut}, timeout=_wait_timeout(watchdog)
            )
            if not done:
                raise asyncio.TimeoutError
            return exec_fut.result()
        done, _ = await asyncio.wait({exec_fut}, timeout=hedge_delay)
        if done:
            return exec_fut.result()
        try:
            rep2 = self.router.route(exclude=tried | {rep.name})
        except NoHealthyReplica:
            done, _ = await asyncio.wait(
                {exec_fut}, timeout=_wait_timeout(watchdog - hedge_delay)
            )
            if not done:
                raise asyncio.TimeoutError
            return exec_fut.result()
        tried.add(rep2.name)  # a failed hedge shouldn't be retried on rep2
        self.metrics.on_hedge()
        try:
            hedge_fut = self._loop.run_in_executor(
                self._pool, self.router.execute_on, rep2, payload,
                None if trace is None else dataclasses.replace(trace, t_call=spans.clock()),
            )
        except Exception:
            self.router.release(rep2)
            done, _ = await asyncio.wait(
                {exec_fut}, timeout=_wait_timeout(watchdog - hedge_delay)
            )
            if not done:
                raise asyncio.TimeoutError
            return exec_fut.result()
        hedge_fut.add_done_callback(_consume_exception)
        pending = {exec_fut, hedge_fut}
        end = time.monotonic() + (watchdog - hedge_delay)
        while pending:
            done, pending = await asyncio.wait(
                pending,
                timeout=_wait_timeout(max(0.0, end - time.monotonic())),
                return_when=asyncio.FIRST_COMPLETED,
            )
            if not done:
                raise asyncio.TimeoutError
            for f in done:
                if f.exception() is None:
                    return f.result()
            # every completed future failed; keep waiting on the rest
        raise exec_fut.exception()  # both attempts failed: surface primary's

    # ------------------------------------------------------------------ #
    # budgets
    # ------------------------------------------------------------------ #
    def _watchdog_budget(self, live: list[_Pending], remaining: float) -> float:
        """Wall-clock budget for one routed attempt (seconds).

        Priced from the strongest signal available: the calibrated
        ``admission_estimate`` (seconds iff a MachineSpec is loaded) and
        the tracked per-batch service p99, scaled by ``watchdog_factor``,
        capped at the riders' remaining deadline, and floored at
        ``watchdog_min`` AND at twice the slowest completed service.
        Until the first service completes there is NO watchdog
        (``math.inf``): the calibrated estimate prices the solve, not the
        plan build (SOI compile, operand build and upload to the card, and
        on a process's first batch the kernels' ``nvcc`` build), so a
        first-of-its-bucket attempt legitimately runs ~100x the estimate
        while its plan builds — abandoning it on that evidence builds the
        plan twice, poisons the health plane, and can resolve ``timeout``
        on a request whose deadline is nowhere near.  The 2x-slowest floor extends the same grace to
        later cold buckets: plan-build spikes enter the service histogram,
        and a budget below an already-witnessed legitimate solve would
        re-fire on every repeat.  A single-replica fleet also gets no
        derived watchdog: abandoning the only replica's attempt is pure
        loss — the retry queues behind the same replica lock, inherits
        the abandoned solve's wait, and overruns again, turning one load
        stall into a spurious ``timeout``.  An explicit
        ``watchdog_budget_ms`` bypasses the derivation — operators (and
        the chaos tests) pin a known-good post-warmup budget instead.
        """
        if self.watchdog_budget is not None:
            return max(min(self.watchdog_budget, remaining), 1e-3)
        if len(self.router) <= 1:
            return math.inf
        p99 = self.metrics.service_quantile(0.99)
        if p99 is None or not math.isfinite(p99) or p99 <= 0.0:
            return math.inf
        est = self._attempt_cost_estimate(live)
        signals = [
            s for s in (est, p99)
            if s is not None and s > 0.0 and math.isfinite(s)
        ]
        spike = self.metrics.service_quantile(1.0) or 0.0
        cap = min(self.watchdog_factor * max(signals), remaining)
        return max(cap, 2.0 * spike, self.watchdog_min, 1e-3)

    def _attempt_cost_estimate(self, live: list[_Pending]) -> float | None:
        """Calibrated seconds for the costliest rider (None uncalibrated)."""
        if getattr(self._db._engine, "spec", None) is None:
            return None  # without a MachineSpec the estimate is not seconds
        return max(self._admission_cost(p.prepared[0]) for p in live)

    def _retry_price(self, live: list[_Pending]) -> float:
        """What one more attempt should cost: estimate, else measured p50."""
        est = self._attempt_cost_estimate(live)
        if est is None:
            est = self.metrics.service_quantile(0.50)
        if est is None or not math.isfinite(est):
            est = 0.0
        return est

    def _hedge_delay(self) -> float | None:
        """Seconds to wait before hedging (None without a tracked p99).

        ``hedge_delay_ms`` pins the delay explicitly, same rationale as
        ``watchdog_budget_ms``.
        """
        if self.hedge_delay is not None:
            return self.hedge_delay
        p99 = self.metrics.service_quantile(0.99)
        if p99 is None or not math.isfinite(p99):
            return None
        return self.hedge_factor * p99

    # ------------------------------------------------------------------ #
    # resolution
    # ------------------------------------------------------------------ #
    def _finish(self, p: _Pending, res: ServeResult) -> None:
        """Resolve one rider exactly once, with its outcome's metrics.

        Metrics and resolution commit together: an already-done future
        (caller cancelled, or resolved by an earlier path) is counted
        nowhere a second time.
        """
        if p.future.done():
            return
        if p.span is not None:
            spans.record("serve.request", p.t_ns, spans.clock(), id=p.span,
                         request=p.rid, tenant=p.tenant, outcome=res.outcome)
        if res.outcome == "ok":
            self.metrics.on_complete(
                p.tenant, res.queue_ms / 1e3, res.total_ms / 1e3
            )
        elif res.outcome == "error":
            self.metrics.on_error(p.tenant)
        elif res.outcome == "timeout":
            self.metrics.on_timeout(p.tenant, res.queue_ms / 1e3)
        else:
            self.metrics.on_shed(p.tenant, res.outcome, res.queue_ms / 1e3)
        p.future.set_result(res)

    def _fail_all(self, pendings: list[_Pending], exc, detail: str) -> None:
        """Resolve every still-pending rider with ``outcome="error"``."""
        now = time.monotonic()
        for p in pendings:  # rl4: track=p
            self._finish(p, ServeResult(
                outcome="error", tenant=p.tenant, error=exc, detail=detail,
                total_ms=(now - p.t_submit) * 1e3,
            ))

    def _timeout_all(self, pendings: list[_Pending], detail: str) -> None:
        """Resolve every still-pending rider with ``outcome="timeout"``."""
        now = time.monotonic()
        for p in pendings:  # rl4: track=p
            self._finish(p, ServeResult(
                outcome="timeout", tenant=p.tenant, detail=detail,
                total_ms=(now - p.t_submit) * 1e3,
            ))


async def stream_pages(
    rs: ResultSet, page_size: int = 100
) -> AsyncIterator[list[tuple[str, str, str]]]:
    """Async-paginate a result set's survivor triples.

    Yields name-triple pages of at most ``page_size``; each page
    materializes on the default executor so a huge survivor set neither
    blocks the event loop nor lands in one response.  The result set pins
    its snapshot, so pagination stays consistent across later mutations.
    """
    loop = asyncio.get_running_loop()
    offset = 0
    while True:
        page = await loop.run_in_executor(None, rs.page, offset, page_size)
        if not page:
            return
        yield page
        offset += len(page)
