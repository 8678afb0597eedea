"""`repro_torch.serve` — the async serving subsystem (DESIGN.md Sect. 10).

Turns the synchronous ``repro_torch.db`` surface into a traffic-shaped
front end: a bounded, admission-controlled request queue with explicit shed
outcomes, deficit-round-robin fairness across tenants sharing one warm
engine, replica routing over immutable snapshots, a real flush timer, and
streaming result delivery::

    from repro_torch.serve import AsyncServer

    async with AsyncServer(db, replicas=2, max_queue=64) as server:
        futs = [server.submit(q, tenant="alice") for q in queries]
        results = await asyncio.gather(*futs)
        assert all(r.outcome in ("ok", "overloaded", "deadline", "cost",
                                 "error", "timeout") for r in results)

The loop also carries the failure plane (DESIGN.md Sect. 14): per-replica
health (healthy → suspect → quarantined → rebuilding) with routing that
skips quarantined members, deadline-budgeted retry and optional hedging, a
per-batch solve watchdog behind the explicit ``timeout`` outcome, and
deterministic fault injection via :mod:`repro_torch.faults`.

Replicas are threads over the database's device: on a card their kernels
share its default stream, so device work serialises there while the host
side of one batch overlaps another's (:mod:`repro_torch.serve.router`).
The module is the JAX package's ``repro.serve`` with the engine imports
moved to the port; ``python -m repro_torch.launch.serve`` drives it.
"""
from .fairness import DeficitRoundRobin
from .metrics import LatencyHistogram, MetricsSnapshot, ServeMetrics
from .router import (
    HEALTHY,
    QUARANTINED,
    REBUILDING,
    SUSPECT,
    NoHealthyReplica,
    Replica,
    ReplicaRouter,
)
from .server import OUTCOMES, AsyncServer, ServeResult, stream_pages

__all__ = [
    "AsyncServer",
    "DeficitRoundRobin",
    "HEALTHY",
    "LatencyHistogram",
    "MetricsSnapshot",
    "NoHealthyReplica",
    "OUTCOMES",
    "QUARANTINED",
    "REBUILDING",
    "Replica",
    "ReplicaRouter",
    "SUSPECT",
    "ServeMetrics",
    "ServeResult",
    "stream_pages",
]
