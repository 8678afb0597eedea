"""Per-tenant weighted fair scheduling: deficit round robin (DESIGN.md
Sect. 10.3).

All tenants of one :class:`~repro_torch.serve.server.AsyncServer` share one warm
engine, so without a scheduler a template storm from one tenant would
occupy every dispatch slot and starve the rest — the classic head-of-line
problem admission control alone cannot fix (admission bounds the *total*
queue, not its composition).  Deficit round robin (Shreedhar & Varghese)
fixes it with O(1) work per dequeue: each backlogged tenant holds a
*deficit* counter topped up by ``quantum * weight`` once per round, and may
dequeue requests while their cost fits the deficit.  Over any backlogged
interval, tenant throughput converges to the weight ratio regardless of
arrival order or burst size.

The scheduler is deliberately loop-agnostic (no asyncio imports): it is
driven from the server's single dispatcher task, so it needs no locking of
its own, and unit tests exercise it synchronously.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Iterator


class DeficitRoundRobin:
    """Weighted deficit-round-robin queue over per-tenant FIFOs.

    ``quantum`` is the deficit top-up per visit for a weight-1.0 tenant, in
    the same unit as item cost (the server uses cost 1.0 per request, so
    quantum = requests per round).  ``weights`` maps tenant -> relative
    weight; unknown tenants default to 1.0.
    """

    def __init__(
        self,
        *,
        quantum: float = 1.0,
        weights: dict[str, float] | None = None,
    ):
        if quantum <= 0:
            raise ValueError("quantum must be > 0")
        self.quantum = quantum
        self.weights = dict(weights or {})
        self._queues: dict[str, deque[tuple[float, Any]]] = {}
        self._deficit: dict[str, float] = {}
        self._active: deque[str] = deque()  # backlogged tenants, round order

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        """Total queued items across all tenants."""
        return sum(len(q) for q in self._queues.values())

    @property
    def tenants(self) -> tuple[str, ...]:
        """Backlogged tenants in current round order."""
        return tuple(self._active)

    def heads(self) -> Iterator[Any]:
        """The head item of every backlogged tenant's FIFO.

        The server scans these for the oldest pending arrival to arm its
        flush timer — per-tenant FIFO order makes the heads sufficient.
        """
        for t in self._active:
            yield self._queues[t][0][1]

    def enqueue(self, tenant: str, item: Any, cost: float = 1.0) -> int:
        """Queue ``item`` for ``tenant``; returns the new total depth."""
        q = self._queues.setdefault(tenant, deque())
        if not q and tenant not in self._active:
            self._active.append(tenant)
            self._deficit.setdefault(tenant, 0.0)
        q.append((cost, item))
        return len(self)

    def take(self, budget: int) -> list[tuple[str, Any]]:
        """Dequeue up to ``budget`` items fairly across backlogged tenants.

        Visits tenants round-robin; each visit tops the tenant's deficit up
        by ``quantum * weight`` and drains head items while their cost fits.
        A tenant emptied mid-round leaves the active list with its deficit
        reset (an idle tenant must not bank credit — that is what makes the
        guarantee *fair* rather than merely work-conserving).
        """
        out: list[tuple[str, Any]] = []
        while len(out) < budget and self._active:
            tenant = self._active.popleft()
            q = self._queues[tenant]
            self._deficit[tenant] += self.quantum * self.weights.get(tenant, 1.0)
            while q and len(out) < budget and q[0][0] <= self._deficit[tenant]:
                cost, item = q.popleft()
                self._deficit[tenant] -= cost
                out.append((tenant, item))
            if q:
                self._active.append(tenant)  # still backlogged: next round
            else:
                self._deficit[tenant] = 0.0  # idle tenants bank nothing
        return out

    def drain(self) -> list[tuple[str, Any]]:
        """Dequeue everything (shutdown path), still in fair order."""
        out: list[tuple[str, Any]] = []
        while self._active:
            out.extend(self.take(max(len(self), 1)))
        return out

    def __repr__(self) -> str:
        depth = {t: len(q) for t, q in self._queues.items() if q}
        return f"DeficitRoundRobin(quantum={self.quantum}, backlog={depth})"
