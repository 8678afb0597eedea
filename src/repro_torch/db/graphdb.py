"""Mutable graph-database handle with snapshot semantics and versioned
plan invalidation (paper Sect. 2 database model; DESIGN.md Sect. 6.1).

The paper treats the database ``G = (V, Sigma, E)`` as a static input; a
database *system* (Angles et al., *Foundations of Modern Query Languages
for Graph Databases*) additionally needs updates and a stable handle the
query surface hangs off.  :class:`GraphDB` is that handle:

* **Snapshot semantics** — the underlying :class:`~repro_torch.core.graph.Graph`
  is never mutated in place.  ``insert``/``delete`` build a *new* triples
  array; anything holding a previous ``snapshot()`` (a result set, an
  in-flight plan) keeps a consistent view.
* **Versioned fingerprints** — a monotone version counter is folded into
  the plan-cache fingerprint (``{content-hash}+v{version}``), so a mutation
  precisely invalidates stale compiled plans: same-template plans rebuild
  lazily on next use, adjacency device arrays for old snapshots are
  dropped, and the cache metrics expose exact invalidation counts
  (:meth:`repro_torch.engine.engine.Engine.refresh`).
* **Set semantics** — ``E`` is a set of labeled edges: inserting a triple
  that already exists, or deleting one that does not, is a no-op and does
  not bump the version (so it invalidates nothing).

The executor behind the handle is :class:`repro_torch.engine.Engine`
(template canonicalization -> LRU plan cache -> microbatching); ``GraphDB``
owns exactly one, shared by every :class:`~repro_torch.db.session.Session`, so
all sessions hit one warm plan cache.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.graph import Graph, GraphDelta
from repro_torch.core.sparql import Query
from repro_torch.engine.batcher import DEFAULT_BUCKETS
from repro_torch.engine.engine import Engine, EngineMetrics, graph_fingerprint

from .results import ResultSet

StrTriple = tuple[str, str, str]

# Per-version deltas kept for incremental plan maintenance; once a stale
# plan falls further behind than this, `delta_since` reports the history as
# truncated and the engine rebuilds cold (DESIGN.md Sect. 8.1).
DELTA_LOG_LIMIT = 64


def _empty_graph() -> Graph:
    return Graph(
        n_nodes=0,
        n_labels=0,
        triples=np.zeros((0, 3), dtype=np.int32),
        node_names=[],
        label_names=[],
    )


class GraphDB:
    """A mutable database handle over immutable :class:`Graph` snapshots.

    Contracts the rest of the system builds on:

    * **Snapshot pinning** — :meth:`query` / :meth:`execute_many` / session
      flushes each pin exactly one snapshot for their whole call; a
      concurrent mutation never makes one batch mix two graph versions.
      Returned :class:`~repro_torch.db.results.ResultSet` objects keep reading
      through the snapshot they were computed against.
    * **Set semantics** — duplicate inserts and missing deletes are no-ops
      that bump nothing and invalidate nothing.
    * **Versioned invalidation** — every effective mutation bumps
      :attr:`version` (folded into :attr:`fingerprint`), records a
      :class:`~repro_torch.core.graph.GraphDelta` in a bounded delta log, and
      lets :meth:`repro_torch.engine.engine.Engine.refresh` classify superseded
      plans as *resumable* (shape-stable delta: operands patched in place,
      previous fixpoint warm-starts the next solve) or *cold* (dictionary
      grew: full rebuild).  ``incremental=False`` disables resumption.
    * **Stable ids** — existing node/label ids never change; deletes keep
      names in the dictionary, inserts append.
    """

    def __init__(
        self,
        graph: Graph | None = None,
        *,
        engine: str = "auto",
        cache_capacity: int = 64,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device=DEFAULT_DEVICE,
        mesh=None,
        n_blocks: int | None = None,
        incremental: bool = True,
        spec=None,
    ):
        """``engine`` picks the fixpoint engine ("auto" = cost-based):
        dense / packed / packed_fused / sparse / jacobi_packed / partitioned
        (the first three only on graphs whose ``[n, n]`` plane may be built,
        see :func:`repro_torch.engine.cost.dense_tier_feasible`).  ``device``
        holds the operands and runs the
        fixpoints: ``"cuda"`` by default, which raises without a card;
        pass ``device="cpu"`` for the plain torch versions.  ``mesh`` is a
        :class:`repro_torch.distributed.ctx.NodeMesh` of ``device``'s type
        (see :func:`repro_torch.distributed.ctx.node_mesh`) the partitioned
        engine places its destination blocks and chi's columns over; with a
        mesh of >= 2 devices, engine="auto" selects "partitioned" once the
        graph outgrows single-device budgets.  ``n_blocks`` overrides the
        number of destination blocks (default: one per mesh device, 4
        without a mesh).  ``incremental``
        enables warm-resume plan maintenance across mutations (DESIGN.md
        Sect. 8); disable it to force every superseded plan cold.  ``spec``
        (a :class:`repro_torch.engine.machine.MachineSpec`) pins the machine
        calibration every cost decision prices with; ``None`` takes the
        machine's persisted spec (``REPRO_MACHINE_SPEC``; the hand-tuned
        model when there is none)."""
        if graph is None:
            graph = _empty_graph()
        if graph.node_names is None or graph.label_names is None:
            raise ValueError(
                "GraphDB needs a graph with node_names/label_names; "
                "build it with Graph.from_triples or assign names first"
            )
        self._graph = graph
        self.version = 0
        self._base_fp = graph_fingerprint(graph)
        self._node_index = {n: i for i, n in enumerate(graph.node_names)}
        self._label_index = {n: i for i, n in enumerate(graph.label_names)}
        # lazily built by _edges(); insert/delete mutate it in place
        self._edge_set: set[tuple[int, int, int]] | None = None  # guarded-by: _lock
        # (version, delta that produced it) — consumed by Engine.refresh()
        self._delta_log: deque[tuple[int, GraphDelta]] = deque(  # guarded-by: _lock
            maxlen=DELTA_LOG_LIMIT
        )
        self._lock = threading.RLock()
        self._engine = Engine(
            self,
            engine=engine,
            cache_capacity=cache_capacity,
            buckets=buckets,
            device=device,
            mesh=mesh,
            n_blocks=n_blocks,
            incremental=incremental,
            spec=spec,
        )

    @classmethod
    def from_triples(cls, triples: Iterable[StrTriple], **kwargs) -> "GraphDB":
        """Build a database from (subject, predicate, object) string triples."""
        return cls(Graph.from_triples(triples), **kwargs)

    # ------------------------------------------------------------------ #
    # the contract Engine.refresh() reads (duck-typed source)
    # ------------------------------------------------------------------ #
    @property
    def graph(self) -> Graph:
        """The current immutable snapshot."""
        return self._graph

    @property
    def fingerprint(self) -> str:
        """Plan-cache fingerprint: content hash of the seed snapshot with
        the monotone version counter folded in."""
        return f"{self._base_fp}+v{self.version}"

    @property
    def node_index(self) -> dict[str, int]:
        """Live node name -> id map (ids are stable across mutations)."""
        return self._node_index

    @property
    def label_index(self) -> dict[str, int]:
        """Live label name -> id map (ids are stable across mutations)."""
        return self._label_index

    # ------------------------------------------------------------------ #
    # convenience views
    # ------------------------------------------------------------------ #
    @property
    def n_nodes(self) -> int:
        """Node count of the current snapshot."""
        return self._graph.n_nodes

    @property
    def n_triples(self) -> int:
        """Triple count of the current snapshot."""
        return self._graph.n_edges

    def snapshot(self) -> Graph:
        """Alias of :attr:`graph`, for callers that want to pin a version."""
        return self._graph

    def __contains__(self, triple: StrTriple) -> bool:
        s, p, o = triple
        ids = (
            self._node_index.get(s),
            self._label_index.get(p),
            self._node_index.get(o),
        )
        if None in ids:
            return False
        # RL3: _edges() lazily builds and caches _edge_set; unlocked it
        # races insert/delete mutating the same set (the lock is re-entrant)
        with self._lock:
            return ids in self._edges()

    def __len__(self) -> int:
        return self.n_triples

    def __repr__(self) -> str:
        return (
            f"GraphDB({self.n_triples} triples, {self.n_nodes} nodes, "
            f"v{self.version})"
        )

    # ------------------------------------------------------------------ #
    # mutation
    # ------------------------------------------------------------------ #
    def _edges(self) -> set[tuple[int, int, int]]:  # requires-lock: _lock
        if self._edge_set is None:
            self._edge_set = {tuple(row) for row in self._graph.triples.tolist()}
        return self._edge_set

    @staticmethod
    def _validated(triples: Iterable[StrTriple]) -> list[StrTriple]:
        """Materialize and type-check up front, so the mutation loops below
        cannot fail halfway and leave the live indexes out of sync with the
        committed snapshot."""
        out = []
        for i, t in enumerate(triples):
            if not (
                isinstance(t, tuple)
                and len(t) == 3
                and all(isinstance(x, str) for x in t)
            ):
                raise TypeError(
                    f"triple #{i} must be a (str, str, str) tuple, got {t!r}"
                )
            out.append(t)
        return out

    def insert(self, triples: Iterable[StrTriple]) -> int:
        """Insert string triples; unseen nodes/labels extend the dictionary.

        Returns the number of triples actually added (set semantics:
        already-present triples do not count and alone do not mutate).
        Bumps :attr:`version` — and thereby invalidates stale plans —
        only when something was added.
        """
        with self._lock:
            triples = self._validated(triples)
            edges = self._edges()
            node_names = list(self._graph.node_names)
            label_names = list(self._graph.label_names)
            added: list[tuple[int, int, int]] = []
            for s, p, o in triples:
                si = self._node_index.get(s)
                if si is None:
                    si = self._node_index[s] = len(node_names)
                    node_names.append(s)
                pi = self._label_index.get(p)
                if pi is None:
                    pi = self._label_index[p] = len(label_names)
                    label_names.append(p)
                oi = self._node_index.get(o)
                if oi is None:
                    oi = self._node_index[o] = len(node_names)
                    node_names.append(o)
                row = (si, pi, oi)
                if row not in edges:
                    edges.add(row)
                    added.append(row)
            if not added:
                # a duplicate triple cannot introduce new names, so the
                # dictionary is untouched too: nothing to commit
                return 0
            rows = np.asarray(added, dtype=np.int32).reshape(-1, 3)
            self._commit(
                Graph(
                    n_nodes=len(node_names),
                    n_labels=len(label_names),
                    triples=np.vstack([self._graph.triples, rows]),
                    node_names=node_names,
                    label_names=label_names,
                ),
                GraphDelta(
                    inserted=rows,
                    deleted=np.zeros((0, 3), np.int32),
                    nodes_before=self._graph.n_nodes,
                    nodes_after=len(node_names),
                    labels_before=self._graph.n_labels,
                    labels_after=len(label_names),
                ),
            )
            return len(added)

    def delete(self, triples: Iterable[StrTriple]) -> int:
        """Delete string triples; names never seen are ignored.

        Nodes and labels stay in the dictionary (ids are stable across
        deletes).  Returns the number of triples actually removed; the
        version bumps only when that is non-zero.
        """
        with self._lock:
            triples = self._validated(triples)
            edges = self._edges()
            doomed: set[tuple[int, int, int]] = set()
            for s, p, o in triples:
                row = (
                    self._node_index.get(s),
                    self._label_index.get(p),
                    self._node_index.get(o),
                )
                if None not in row and row in edges:
                    doomed.add(row)  # type: ignore[arg-type]
            if not doomed:
                return 0
            keep = np.asarray(
                [tuple(r) not in doomed for r in self._graph.triples.tolist()],
                dtype=bool,
            )
            self._edge_set = edges - doomed
            n, la = self._graph.n_nodes, self._graph.n_labels
            self._commit(
                Graph(
                    n_nodes=n,
                    n_labels=la,
                    triples=self._graph.triples[keep],
                    node_names=self._graph.node_names,
                    label_names=self._graph.label_names,
                ),
                GraphDelta(
                    inserted=np.zeros((0, 3), np.int32),
                    deleted=np.asarray(sorted(doomed), np.int32).reshape(-1, 3),
                    nodes_before=n,
                    nodes_after=n,
                    labels_before=la,
                    labels_after=la,
                ),
            )
            return len(doomed)

    def _commit(self, graph: Graph, delta: GraphDelta) -> None:  # requires-lock: _lock
        self._graph = graph
        self.version += 1
        self._delta_log.append((self.version, delta))

    def delta_since(self, version: int) -> GraphDelta | None:
        """The composed :class:`GraphDelta` from ``version`` to now.

        Returns ``None`` when the bounded delta log no longer reaches back
        to ``version`` (or the version is unknown) — the caller must then
        treat anything pinned to that version as cold.  Inserts cancelled
        by later deletes (and vice versa) drop out of the composition.
        """
        with self._lock:
            entries = [d for v, d in self._delta_log if v > version]
            if len(entries) != self.version - version or not entries:
                return None  # log truncated before `version` (or no change)
            out = entries[0]
            for d in entries[1:]:
                out = out.compose(d)
            return out

    # ------------------------------------------------------------------ #
    # querying
    # ------------------------------------------------------------------ #
    def session(self, **kwargs) -> "Session":
        """Open a :class:`~repro_torch.db.session.Session` over this database."""
        from .session import Session

        return Session(self, **kwargs)

    def query(self, query) -> ResultSet:
        """One-shot convenience: execute a single query synchronously.

        ``query`` may be text, a parsed :class:`Query`, or a
        :class:`~repro_torch.db.builder.Q` builder.  For request streams, use
        :meth:`session` — it microbatches same-template requests.
        """
        with self._lock:
            raw = self._engine.execute(self._coerce(query))
            return ResultSet(raw, self._engine.db)

    def execute_many(self, queries) -> list[ResultSet]:
        """Synchronously execute a request list with microbatching."""
        with self._lock:
            raws = self._engine.execute_many(
                [self._coerce(q) for q in queries]
            )
            snap = self._engine.db
            return [ResultSet(r, snap) for r in raws]

    def _execute_prepared(self, prepared) -> list[ResultSet]:
        """Session flush path: requests already split by Engine.prepare."""
        with self._lock:
            raws = self._engine.execute_prepared(prepared)
            snap = self._engine.db
            return [ResultSet(r, snap) for r in raws]

    @staticmethod
    def _coerce(query) -> str | Query:
        build = getattr(query, "build", None)  # Q builder without an import
        return build() if callable(build) else query

    def metrics(self) -> EngineMetrics:
        """Serving counters: cache hits/misses, invalidation classes
        (cold vs resumable vs resumed), microbatches, per-stage seconds.

        The copy is a single lock-protected snapshot
        (:meth:`repro_torch.engine.engine.Engine.stats`), safe to read from any
        thread while sessions and the serving loop are in flight.
        """
        return self._engine.stats()

    def stats(self) -> EngineMetrics:
        """Alias of :meth:`metrics` (the engine-level name)."""
        return self._engine.stats()
