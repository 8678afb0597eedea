"""Seeded, thread-safe fault plans driving the serving chaos tests.

A :class:`FaultPlan` is a declarative schedule of injections:

- ``crash_replica(name, at_batch=k)`` — the k-th batch started on that
  replica (counted from :meth:`arm`) raises :class:`InjectedCrash`, and the
  replica stays crashed (every later batch fails fast) until
  :meth:`heal` is called — which is exactly what a rebuild does.
- ``slow_replica(name, factor=f, extra_s=s)`` — a chronic straggler: each
  batch on that replica is stretched to ``f``× its measured service time
  plus ``s`` seconds of absolute delay.
- ``poison_matching(marker)`` — any prepared request whose constants or
  query text contain ``marker`` raises :class:`InjectedPoison` from inside
  ``Engine.execute_prepared`` (on *every* replica: poison travels with the
  request, not the host).
- ``reject_dispatch(at_dispatch=k, count=c)`` — dispatches ``k..k+c-1``
  (counted from :meth:`arm`) raise :class:`InjectedReject` before the batch
  reaches the executor, simulating a rejected/shut-down pool.
- ``fail_refresh(name, times=t)`` — the next ``t`` fence refreshes of that
  replica raise :class:`InjectedRefreshFailure`.

Plans start disarmed; every hook is a no-op until :meth:`arm` runs, so a
server can be constructed (and warmed) with the plan attached and the fault
clock starts only when the measured phase does.  All state is guarded by a
single internal lock; hook cost while disarmed is one attribute read.
"""

from __future__ import annotations

import threading
import time
from typing import Any


class InjectedFault(RuntimeError):
    """Base class for all injected failures (never raised by real code)."""


class InjectedCrash(InjectedFault):
    """The routed replica crashed: the whole batch attempt is lost."""


class InjectedPoison(InjectedFault):
    """A poisoned request: fails deterministically on every replica."""


class InjectedReject(InjectedFault):
    """The executor rejected the batch before any replica ran it."""


class InjectedRefreshFailure(InjectedFault):
    """A replica's ``refresh()`` failed during a fence."""


class FaultPlan:
    """A seeded schedule of failures injected into the serving path."""

    def __init__(self, seed: int = 0) -> None:
        """Create an empty, disarmed plan (``seed`` is recorded for reports)."""
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._armed = False
        self._crash_at: dict[str, int] = {}  # guarded-by: self._lock
        self._crashed: set[str] = set()  # guarded-by: self._lock
        self._slow: dict[str, tuple[float, float]] = {}  # guarded-by: self._lock
        self._poison_markers: list[str] = []  # guarded-by: self._lock
        self._reject_window: tuple[int, int] | None = None  # guarded-by: self._lock
        self._refresh_failures: dict[str, int] = {}  # guarded-by: self._lock
        self._batch_seq: dict[str, int] = {}  # guarded-by: self._lock
        self._dispatch_seq = 0  # guarded-by: self._lock
        self._counts: dict[str, Any] = {}  # guarded-by: self._lock
        self._crash_fired: dict[str, dict[str, float]] = {}  # guarded-by: self._lock

    # -- schedule builders -------------------------------------------------

    def crash_replica(self, name: str, at_batch: int = 1) -> "FaultPlan":
        """Crash ``name`` on its ``at_batch``-th armed batch; stays down until healed."""
        with self._lock:
            self._crash_at[name] = max(1, int(at_batch))
        return self

    def slow_replica(
        self, name: str, factor: float = 1.0, extra_s: float = 0.0
    ) -> "FaultPlan":
        """Stretch each batch on ``name`` to ``factor``× service + ``extra_s`` seconds."""
        with self._lock:
            self._slow[name] = (max(1.0, float(factor)), max(0.0, float(extra_s)))
        return self

    def poison_matching(self, marker: str) -> "FaultPlan":
        """Poison every request whose constants or text contain ``marker``."""
        with self._lock:
            self._poison_markers.append(str(marker))
        return self

    def reject_dispatch(self, at_dispatch: int = 1, count: int = 1) -> "FaultPlan":
        """Reject dispatches ``at_dispatch .. at_dispatch + count - 1`` (armed count)."""
        with self._lock:
            lo = max(1, int(at_dispatch))
            self._reject_window = (lo, lo + max(1, int(count)))
        return self

    def fail_refresh(self, name: str, times: int = 1) -> "FaultPlan":
        """Make the next ``times`` fence refreshes of ``name`` raise."""
        with self._lock:
            self._refresh_failures[name] = max(1, int(times))
        return self

    # -- lifecycle ---------------------------------------------------------

    def arm(self) -> "FaultPlan":
        """Start the fault clock: reset sequence counters and enable hooks."""
        with self._lock:
            self._batch_seq.clear()
            self._dispatch_seq = 0
            self._armed = True
        return self

    def disarm(self) -> "FaultPlan":
        """Stop injecting (schedule and counters are preserved)."""
        with self._lock:
            self._armed = False
        return self

    def heal(self, name: str) -> None:
        """Clear the crashed state of ``name`` (called by replica rebuild)."""
        with self._lock:
            self._crashed.discard(name)
            self._crash_at.pop(name, None)

    # -- injection hooks ---------------------------------------------------

    def on_batch_start(self, replica: str) -> None:
        """Raise :class:`InjectedCrash` if ``replica`` is (or just became) crashed."""
        with self._lock:
            if not self._armed:
                return
            if replica in self._crashed:
                self._bump("crash")
                raise InjectedCrash(f"replica {replica} is crashed (injected)")
            at = self._crash_at.get(replica)
            if at is None:
                return
            n = self._batch_seq.get(replica, 0) + 1
            self._batch_seq[replica] = n
            if n >= at:
                self._crashed.add(replica)
                self._crash_fired[replica] = {"batch": float(n), "t": time.monotonic()}
                self._bump("crash")
                raise InjectedCrash(
                    f"replica {replica} crashed at armed batch {n} (injected)"
                )

    def solve_penalty(self, replica: str, measured_s: float) -> float:
        """Extra seconds to sleep after a batch on ``replica`` (0.0 when clean)."""
        with self._lock:
            if not self._armed:
                return 0.0
            cfg = self._slow.get(replica)
            if cfg is None:
                return 0.0
            factor, extra = cfg
            penalty = (factor - 1.0) * max(0.0, measured_s) + extra
            if penalty > 0.0:
                self._counts["slow_s"] = self._counts.get("slow_s", 0.0) + penalty
            return penalty

    def on_execute_prepared(self, prepared: list) -> None:
        """Raise :class:`InjectedPoison` if any prepared request matches a marker."""
        with self._lock:
            if not self._armed or not self._poison_markers:
                return
            markers = tuple(self._poison_markers)
        for item in prepared:
            if self.matches_poison(item):
                with self._lock:
                    self._bump("poison")
                raise InjectedPoison(
                    f"poisoned request (markers={markers!r}): {item!r}"
                )

    def on_dispatch(self) -> None:
        """Raise :class:`InjectedReject` if this armed dispatch is scheduled to fail."""
        with self._lock:
            if not self._armed or self._reject_window is None:
                return
            self._dispatch_seq += 1
            lo, hi = self._reject_window
            if lo <= self._dispatch_seq < hi:
                self._bump("reject")
                raise InjectedReject(
                    f"dispatch {self._dispatch_seq} rejected (injected)"
                )

    def on_refresh(self, replica: str) -> None:
        """Raise :class:`InjectedRefreshFailure` if a refresh failure is pending."""
        with self._lock:
            if not self._armed:
                return
            left = self._refresh_failures.get(replica, 0)
            if left > 0:
                self._refresh_failures[replica] = left - 1
                self._bump("refresh")
                raise InjectedRefreshFailure(
                    f"refresh of replica {replica} failed (injected)"
                )

    # -- introspection -----------------------------------------------------

    def matches_poison(self, item: Any) -> bool:
        """True when a prepared ``(query, instance)`` pair matches a poison marker."""
        with self._lock:
            markers = tuple(self._poison_markers)
        if not markers:
            return False
        try:
            _q, inst = item
        except (TypeError, ValueError):
            _q, inst = item, None
        consts = getattr(inst, "constants", None)
        hay = " ".join(str(c) for c in consts) if consts else repr(_q)
        return any(m in hay for m in markers)

    def bind(self, replica: str) -> "BoundFaults":
        """Return the per-replica hook object installed as ``Engine.faults``."""
        return BoundFaults(self, replica)

    def counts(self) -> dict[str, Any]:
        """Snapshot of fired-injection counters (crash/poison/reject/refresh/slow_s)."""
        with self._lock:
            return dict(self._counts)

    def crash_fired(self, replica: str) -> dict[str, float] | None:
        """When (armed batch no. + monotonic time) ``replica`` crashed, if it did."""
        with self._lock:
            rec = self._crash_fired.get(replica)
            return dict(rec) if rec is not None else None

    # requires-lock: _lock
    def _bump(self, key: str) -> None:
        self._counts[key] = self._counts.get(key, 0) + 1


class BoundFaults:
    """A plan bound to one replica name — the ``Engine.faults`` hook surface."""

    __slots__ = ("plan", "replica")

    def __init__(self, plan: FaultPlan, replica: str) -> None:
        """Bind ``plan``'s request-level hooks to ``replica``."""
        self.plan = plan
        self.replica = replica

    def on_execute_prepared(self, prepared: list) -> None:
        """Engine-side hook: poison check over a prepared batch."""
        self.plan.on_execute_prepared(prepared)
