"""Deterministic fault injection for the serving path (DESIGN.md Sect. 14).

Every failure mode the serving plane claims to survive — a replica that
crashes mid-run, a chronic straggler, a poisoned query, an executor that
rejects work, a refresh that raises — is expressible as a seeded
:class:`FaultPlan` so chaos runs are reproducible tests, not war stories.
Hooks thread through ``ReplicaRouter``, ``Engine.execute_prepared`` and
``AsyncServer`` as zero-cost no-ops when no plan is armed.
"""

from .plan import (
    BoundFaults,
    FaultPlan,
    InjectedCrash,
    InjectedFault,
    InjectedPoison,
    InjectedRefreshFailure,
    InjectedReject,
)

__all__ = [
    "BoundFaults",
    "FaultPlan",
    "InjectedCrash",
    "InjectedFault",
    "InjectedPoison",
    "InjectedRefreshFailure",
    "InjectedReject",
]
