"""`repro_torch.db` — the session-oriented public API of the dual-simulation
database (DESIGN.md Sect. 6).

The paper positions dual simulation as a *database* primitive: a sound
over-approximation for the full SPARQL fragment S (Pérez et al.'s algebra,
paper Sect. 4) fast enough to sit in front of a real query processor.  This
package is the database-shaped surface over the engine internals::

    from repro_torch.db import GraphDB, Q

    db = GraphDB.from_triples(triples)
    db.insert([("Dept9", "subOrganizationOf", "Univ0")])   # versioned

    rs = db.query(Q.triple("?d", "subOrganizationOf", "Univ0")
                   .triple("?s", "memberOf", "?d"))
    rs.bindings("s")               # node names, lazily materialized
    list(rs.survivor_triples(limit=10))

    with db.session(max_delay_ms=5) as s:        # cross-request batching
        futs = [s.submit(q) for q in queries]
        rows = [f.result() for f in futs]

Layers (one module each):

* :class:`GraphDB` — mutable handle, snapshot semantics, monotone version
  counter folded into the plan-cache fingerprint (precise invalidation),
  bounded per-version delta log driving incremental plan maintenance:
  shape-stable mutations patch superseded plans in place and warm-resume
  their fixpoints instead of rebuilding (DESIGN.md Sect. 8).
* :class:`Session` / :class:`ResultFuture` — deadline/size admission over
  the engine's microbatcher.
* :class:`Q` — fluent builder for the Sect.-4 algebra; round-trips through
  :func:`repro_torch.core.sparql.format_query` / ``parse``.
* :class:`ResultSet` — lazy named bindings, survivor-triple pagination,
  honest per-request timing.

`repro_torch.engine` remains the internal executor; importing its ``ExecResult``
still works but emits a :class:`DeprecationWarning`.
"""
from .builder import Q
from .graphdb import GraphDB
from .results import ResultSet
from .session import ResultFuture, Session

__all__ = ["GraphDB", "Q", "ResultFuture", "ResultSet", "Session"]
