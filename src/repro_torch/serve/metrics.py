"""Serving observability: lock-consistent counters + latency histograms
(DESIGN.md Sect. 10.5).

The serving loop is judged by its tail, not its mean: an open-loop
saturation sweep needs p50/p99 queue and
end-to-end latency, shed counts *by cause*, and per-tenant throughput —
and it needs them as one *consistent* snapshot, because the dispatcher,
the replica pool, and the benchmark reader all touch the counters from
different threads.  Every mutation and the whole :meth:`ServeMetrics.
snapshot` copy therefore run under one lock; a reader can never observe
``completed`` incremented while its latency sample is still missing.

Latencies go into fixed geometric buckets (:class:`LatencyHistogram`)
rather than per-request lists, so a saturation run's memory cost is O(1)
in request count and quantiles are one pass over ~40 ints.
"""
from __future__ import annotations

import dataclasses
import threading

# Geometric bucket upper edges in seconds: 50us .. ~190s, x1.5 per step.
# Quantiles resolve to a bucket's upper edge, i.e. within +50% of the true
# value — plenty for p50/p99 on a log-scale latency axis.
_EDGES: tuple[float, ...] = tuple(50e-6 * 1.5**k for k in range(38))

SHED_CAUSES = ("overloaded", "cost", "deadline")


class LatencyHistogram:
    """Fixed-bucket geometric latency histogram with quantile readout."""

    __slots__ = ("counts", "n", "total")

    def __init__(self):
        self.counts = [0] * (len(_EDGES) + 1)  # +1: overflow bucket
        self.n = 0
        self.total = 0.0

    def add(self, seconds: float) -> None:
        """Record one latency sample (seconds)."""
        lo, hi = 0, len(_EDGES)
        while lo < hi:  # first bucket whose upper edge holds the sample
            mid = (lo + hi) // 2
            if seconds <= _EDGES[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.n += 1
        self.total += seconds

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of the ``q`` quantile (0 when empty)."""
        if self.n == 0:
            return 0.0
        rank = max(1, int(q * self.n + 0.999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return _EDGES[i] if i < len(_EDGES) else float("inf")
        return _EDGES[-1]

    @property
    def mean(self) -> float:
        """Mean of the recorded samples (exact, not bucketed)."""
        return self.total / self.n if self.n else 0.0

    def summary(self) -> dict[str, float]:
        """``{n, mean_ms, p50_ms, p99_ms, max_bucket_ms}`` in milliseconds."""
        return {
            "n": self.n,
            "mean_ms": self.mean * 1e3,
            "p50_ms": self.quantile(0.50) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
        }


@dataclasses.dataclass
class MetricsSnapshot:
    """One consistent copy of the serving counters (plain data, no locks)."""

    submitted: int
    admitted: int
    completed: int
    errors: int
    shed: dict[str, int]  # cause -> count (SHED_CAUSES)
    queue_depth: int
    queue_peak: int
    per_tenant: dict[str, dict[str, int]]  # tenant -> submitted/completed/shed
    queue_wait: dict[str, float]  # LatencyHistogram.summary() of queue time
    latency: dict[str, float]  # summary() of end-to-end completed latency
    service: dict[str, float]  # summary() of per-batch service time
    # failure-plane counters; defaulted so older constructors
    # and serialized snapshots stay valid
    timeouts: int = 0  # requests resolved with the explicit timeout outcome
    retries: int = 0  # batch attempts re-dispatched to another replica
    hedges: int = 0  # speculative duplicate dispatches past the tracked p99
    watchdog_overruns: int = 0  # attempts abandoned by the solve watchdog

    @property
    def shed_total(self) -> int:
        """All shed requests, any cause."""
        return sum(self.shed.values())

    @property
    def shed_rate(self) -> float:
        """Fraction of submitted requests shed (0 when nothing submitted)."""
        return self.shed_total / self.submitted if self.submitted else 0.0

    @property
    def resolved(self) -> int:
        """Every request that reached a terminal outcome, any outcome."""
        return self.completed + self.shed_total + self.errors + self.timeouts


class ServeMetrics:
    """Thread-safe serving counters with a single-lock snapshot.

    Invariants every :meth:`snapshot` satisfies (asserted in tests):
    ``submitted == admitted + shed_total + errors_at_admission`` is folded
    into ``submitted >= admitted + shed_total`` and
    ``admitted >= completed + shed["deadline"]`` while requests are in
    flight; once the server has drained,
    ``submitted == completed + shed_total + errors + timeouts``
    (the :attr:`MetricsSnapshot.resolved` identity).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._submitted = 0  # guarded-by: _lock
        self._admitted = 0  # guarded-by: _lock
        self._completed = 0  # guarded-by: _lock
        self._errors = 0  # guarded-by: _lock
        self._shed = {cause: 0 for cause in SHED_CAUSES}  # guarded-by: _lock
        self._queue_depth = 0  # guarded-by: _lock
        self._queue_peak = 0  # guarded-by: _lock
        self._per_tenant: dict[str, dict[str, int]] = {}  # guarded-by: _lock
        self._queue_wait = LatencyHistogram()  # guarded-by: _lock
        self._latency = LatencyHistogram()  # guarded-by: _lock
        self._service = LatencyHistogram()  # guarded-by: _lock
        self._timeouts = 0  # guarded-by: _lock
        self._retries = 0  # guarded-by: _lock
        self._hedges = 0  # guarded-by: _lock
        self._watchdog_overruns = 0  # guarded-by: _lock

    # ------------------------------------------------------------------ #
    # requires-lock: _lock
    def _tenant(self, tenant: str) -> dict[str, int]:
        return self._per_tenant.setdefault(
            tenant, {"submitted": 0, "completed": 0, "shed": 0, "errors": 0}
        )

    def on_submit(self, tenant: str) -> None:
        """One request arrived at the admission gate."""
        with self._lock:
            self._submitted += 1
            self._tenant(tenant)["submitted"] += 1

    def on_admit(self, depth: int) -> None:
        """One request passed admission; ``depth`` is the new queue depth."""
        with self._lock:
            self._admitted += 1
            self._queue_depth = depth
            self._queue_peak = max(self._queue_peak, depth)

    def on_shed(self, tenant: str, cause: str, queue_s: float = 0.0) -> None:
        """One request shed (``cause`` in :data:`SHED_CAUSES`)."""
        with self._lock:
            self._shed[cause] += 1
            self._tenant(tenant)["shed"] += 1
            if queue_s > 0.0:  # deadline sheds waited in queue first
                self._queue_wait.add(queue_s)

    def on_complete(self, tenant: str, queue_s: float, total_s: float) -> None:
        """One admitted request finished with a result."""
        with self._lock:
            self._completed += 1
            self._tenant(tenant)["completed"] += 1
            self._queue_wait.add(queue_s)
            self._latency.add(total_s)

    def on_error(self, tenant: str) -> None:
        """One request failed with an exception (its own, not its batch's)."""
        with self._lock:
            self._errors += 1
            self._tenant(tenant)["errors"] += 1

    def on_timeout(self, tenant: str, queue_s: float = 0.0) -> None:
        """One admitted request exhausted its deadline across attempts."""
        with self._lock:
            self._timeouts += 1
            self._tenant(tenant)["timeouts"] = (
                self._tenant(tenant).get("timeouts", 0) + 1
            )
            if queue_s > 0.0:
                self._queue_wait.add(queue_s)

    def on_retry(self) -> None:
        """One batch attempt was re-dispatched to a different replica."""
        with self._lock:
            self._retries += 1

    def on_hedge(self) -> None:
        """One speculative hedge dispatch was issued."""
        with self._lock:
            self._hedges += 1

    def on_watchdog(self) -> None:
        """One routed attempt was abandoned by the solve watchdog."""
        with self._lock:
            self._watchdog_overruns += 1

    def service_quantile(self, q: float) -> float | None:
        """Per-batch service-time quantile in seconds (None with no samples)."""
        with self._lock:
            if self._service.n == 0:
                return None
            return self._service.quantile(q)

    def on_batch(self, service_s: float, depth: int) -> None:
        """One microbatch finished executing; ``depth`` is the queue now."""
        with self._lock:
            self._service.add(service_s)
            self._queue_depth = depth

    def set_queue_depth(self, depth: int) -> None:
        """Update the queue-depth gauge (and its high-water mark)."""
        with self._lock:
            self._queue_depth = depth
            self._queue_peak = max(self._queue_peak, depth)

    # ------------------------------------------------------------------ #
    def snapshot(self) -> MetricsSnapshot:
        """One consistent copy of every counter, under a single lock."""
        with self._lock:
            return MetricsSnapshot(
                submitted=self._submitted,
                admitted=self._admitted,
                completed=self._completed,
                errors=self._errors,
                shed=dict(self._shed),
                queue_depth=self._queue_depth,
                queue_peak=self._queue_peak,
                per_tenant={t: dict(d) for t, d in self._per_tenant.items()},
                queue_wait=self._queue_wait.summary(),
                latency=self._latency.summary(),
                service=self._service.summary(),
                timeouts=self._timeouts,
                retries=self._retries,
                hedges=self._hedges,
                watchdog_overruns=self._watchdog_overruns,
            )
