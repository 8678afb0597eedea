"""Sessions: deadline/size-batched request admission over the microbatcher
(DESIGN.md 6.2; ROADMAP "async request queues" seam).

A :class:`Session` turns the engine's list-at-a-time ``execute_many`` into
a submit/flush surface: ``submit(query)`` returns a :class:`ResultFuture`
immediately, and pending requests are released to the engine as one
microbatched flush when the *admission policy* fires:

* **bucket cap** — as soon as any one template accumulates
  ``max_pending`` requests (default: the engine's largest microbatch
  bucket), waiting longer cannot improve batching, so the session flushes.
  N concurrent same-template submits therefore cost at most
  ``ceil(N / max_bucket)`` fixpoint solves.
* **deadline** — the first pending submit arms a ``max_delay_ms`` deadline;
  a submit arriving at or past it flushes everything (the late arrival
  rides along).  ``max_delay_ms=0`` degenerates to synchronous execution.
* **explicit** — ``flush()``, ``future.result()`` on an unresolved future,
  or leaving the ``with`` block.

By default the API is synchronous-cooperative: deadlines are checked at
submit and result boundaries, so behaviour is fully deterministic for
tests and single-threaded servers.  With ``auto_flush=True`` a background
flusher thread makes ``max_delay_ms`` a *real* timer: the deadline fires
even if no further submit or result call ever arrives (the serving-loop
regime, DESIGN.md Sect. 10).  Session state is lock-protected either way,
so submits and flushes may come from concurrent threads.  All sessions of
one :class:`~repro_torch.db.graphdb.GraphDB` share its engine, so they share one
warm plan cache; the database lock serializes flushes from concurrent
threads.

A flush isolates failures per request: if a batched execution raises, the
batch re-runs request-by-request and only the offending request's future
carries the exception — sibling futures still resolve with their results.
"""
from __future__ import annotations

import threading
import time

from repro_torch.core.sparql import Query
from repro_torch.engine.template import TemplateInstance

from .results import ResultSet


class ResultFuture:
    """Handle for one submitted request; resolves when its batch flushes."""

    __slots__ = ("_session", "_result", "_error")

    def __init__(self, session: "Session"):
        self._session = session
        self._result: ResultSet | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        """True once the request's batch has flushed and resolved it."""
        return self._result is not None or self._error is not None

    def result(self) -> ResultSet:
        """The request's :class:`ResultSet`, flushing the session if needed.

        Raises the request's *own* execution exception if it failed —
        sibling requests of the same flush are unaffected.
        """
        if not self.done():
            self._session.flush()
        if self._error is not None:
            raise self._error
        if self._result is None:
            # only reachable when an exception tore down the session's
            # `with` block and dropped its pending work unresolved
            raise RuntimeError(
                "request was dropped: its session exited on an exception "
                "before flushing"
            )
        return self._result

    def _resolve(self, rs: ResultSet) -> None:
        self._result = rs

    def _reject(self, exc: BaseException) -> None:
        self._error = exc


class _BackgroundFlusher(threading.Thread):
    """Daemon timer that fires a session's ``max_delay_ms`` for real.

    Sleeps on a condition variable until the session's armed deadline (or
    until notified of a new, earlier one); past the deadline it calls
    ``flush()``, which resolves every pending future.  Execution errors
    cannot escape the flush (per-request isolation), so the thread only
    dies on shutdown.
    """

    def __init__(self, session: "Session"):
        super().__init__(name="session-flusher", daemon=True)
        self._session = session
        self.cv = threading.Condition()
        self._stop = False  # guarded-by: cv
        # The flusher's own copy of the armed deadline, handed over by
        # poke().  RL3: reading session._deadline here would cross into
        # state guarded by the *session* lock while holding only the cv —
        # and taking the session lock under the cv would invert submit's
        # `_lock -> cv` acquisition order (deadlock).
        self._armed: float | None = None  # guarded-by: cv

    def run(self) -> None:
        while True:
            with self.cv:
                if self._stop:
                    return
                wait = (
                    None if self._armed is None
                    else self._armed - time.monotonic()
                )
                if wait is None or wait > 0:
                    self.cv.wait(timeout=wait)
                    continue
                self._armed = None  # consumed: re-armed by the next poke()
            # deadline passed: flush outside the cv (flush takes the
            # session lock; submit holds it while notifying)
            self._session.flush()

    def stop(self) -> None:
        """Unblock and terminate the timer thread."""
        with self.cv:
            self._stop = True
            self.cv.notify()

    def poke(self, deadline: float) -> None:
        """Hand over a freshly armed deadline (called by submit)."""
        with self.cv:
            self._armed = deadline
            self.cv.notify()


class Session:
    """Submit/flush request surface over one :class:`GraphDB`."""

    def __init__(
        self,
        db,
        *,
        max_delay_ms: float = 5.0,
        max_pending: int | None = None,
        auto_flush: bool = False,
    ):
        if max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        self._db = db
        self._engine = db._engine
        self.max_delay_ms = max_delay_ms
        self.max_pending = (
            max_pending if max_pending is not None else max(self._engine.buckets)
        )
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self._pending: list[  # guarded-by: _lock
            tuple[ResultFuture, tuple[Query, TemplateInstance | None]]
        ] = []
        # per template key: the *unique* constant tuples pending.  Duplicate
        # submits share one instance slot in the microbatch (the batcher
        # dedups before chunking), so only unique tuples count toward the
        # bucket cap — N identical submits never force an early flush.
        self._group_consts: dict[str, set[tuple[str, ...]]] = {}  # guarded-by: _lock
        self._deadline: float | None = None  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        self.submitted = 0  # guarded-by: _lock
        self.flushes = 0  # guarded-by: _lock
        self._lock = threading.RLock()
        self._flusher = _BackgroundFlusher(self) if auto_flush else None
        if self._flusher is not None:
            self._flusher.start()

    # ------------------------------------------------------------------ #
    @property
    def pending(self) -> int:
        """Requests submitted but not yet released to the engine."""
        with self._lock:  # RL3: submits/flushes mutate the list concurrently
            return len(self._pending)

    def submit(self, query) -> ResultFuture:
        """Queue one request; returns a future resolved at the next flush.

        ``query`` may be text, a parsed :class:`Query`, or a
        :class:`~repro_torch.db.builder.Q` builder.  Parsing happens here so
        syntax errors surface at the submit site, not inside a later flush.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("session is closed")
            # prepare (parse + union_split + canonicalize) exactly once: the
            # admission counter needs the template key here, and the flush
            # hands the prepared pair straight to Engine.execute_prepared
            q, inst = self._engine.prepare(self._db._coerce(query))
            fut = ResultFuture(self)
            self._pending.append((fut, (q, inst)))
            self.submitted += 1

            # admission policy ------------------------------------------ #
            now = time.monotonic()
            if self._deadline is None:
                self._deadline = now + self.max_delay_ms / 1e3
                if self._flusher is not None:
                    self._flusher.poke(self._deadline)  # hand the deadline over
            if inst is not None:
                # same template key => same microbatch; unique constant
                # tuples count toward its cap (duplicates ride a slot)
                seen = self._group_consts.setdefault(inst.template.key, set())
                seen.add(inst.constants)
                if len(seen) >= self.max_pending:
                    self.flush()
                    return fut
            if now >= self._deadline:
                self.flush()
            return fut

    def flush(self) -> int:
        """Release all pending requests as one microbatched engine call.

        Resolves every pending future; returns how many were resolved.
        Failures are isolated per request: if the batched execution
        raises, the batch re-runs one request at a time so only the
        offending request's future is rejected with the exception, and its
        siblings still resolve with results (regression: a poisoned
        request used to leave the whole flush unresolved).
        """
        with self._lock:
            if not self._pending:
                self._deadline = None
                return 0
            pending, self._pending = self._pending, []
            self._group_consts.clear()
            self._deadline = None
            try:
                results = self._db._execute_prepared(
                    [prep for _, prep in pending]
                )
            except Exception:
                # isolate the poisoned request: siblings get their results,
                # the offender's future carries its own exception
                for fut, prep in pending:  # rl4: track=fut
                    try:
                        fut._resolve(self._db._execute_prepared([prep])[0])
                    except Exception as exc:
                        fut._reject(exc)
            else:
                for (fut, _), rs in zip(pending, results):  # rl4: track=fut
                    fut._resolve(rs)
            self.flushes += 1
            return len(pending)

    def close(self) -> None:
        """Flush outstanding work and reject further submits."""
        with self._lock:
            if self._closed:
                return
            self.flush()
            self._closed = True
        if self._flusher is not None:
            self._flusher.stop()

    # ------------------------------------------------------------------ #
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            # an exception unwound the block: drop pending work unresolved
            # rather than masking the error with a flush that may also fail
            with self._lock:
                self._pending.clear()
                self._group_consts.clear()
                self._deadline = None
                self._closed = True
            if self._flusher is not None:
                self._flusher.stop()

    def __repr__(self) -> str:
        with self._lock:  # RL3: one consistent snapshot of the counters
            n_pending, submitted, flushes = (
                len(self._pending), self.submitted, self.flushes,
            )
        return (
            f"Session(pending={n_pending}, submitted={submitted}, "
            f"flushes={flushes}, max_delay_ms={self.max_delay_ms}, "
            f"max_pending={self.max_pending})"
        )
