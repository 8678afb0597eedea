"""Lazy result sets over survivor masks (paper Sect. 5; DESIGN.md 6.4).

The engine's raw outcome is numeric: a boolean survivor mask over the
database triples (Theorems 1/2 pruning) and per-variable candidate node
masks.  :class:`ResultSet` is the *public* view of that outcome: bindings
materialize to node **names** on first access (via the snapshot's
dictionary) and are cached, survivor triples iterate and paginate without
ever materializing the full name list, and timing/provenance is honest
per-request — ``timings["total"]`` is this request's fair share of its
microbatch, ``timings["batch_total"]`` the whole microbatch wall time.

A ``ResultSet`` pins the :class:`~repro_torch.core.graph.Graph` snapshot it was
computed against, so results stay self-consistent across subsequent
``GraphDB.insert``/``delete`` calls (snapshot semantics).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.pruning import PruneStats
from repro_torch.engine.engine import ExecResult

StrTriple = tuple[str, str, str]


class ResultSet:
    """Lazy, named, paginated view of one request's pruning outcome."""

    def __init__(self, raw: ExecResult, snapshot: Graph):
        self._raw = raw
        self._snapshot = snapshot
        self._name_cache: dict[str, list[str]] = {}
        self._survivor_ids: np.ndarray | None = None

    # ------------------------------------------------------------------ #
    # provenance / stats passthrough
    # ------------------------------------------------------------------ #
    @property
    def snapshot(self) -> Graph:
        """The graph snapshot this result was computed against."""
        return self._snapshot

    @property
    def stats(self) -> PruneStats:
        """Pruning statistics (triple counts before/after, per-edge splits)."""
        return self._raw.stats

    @property
    def sweeps(self) -> int:
        """Fixpoint sweeps the solve took (warm resumes take far fewer)."""
        return self._raw.sweeps

    @property
    def engine(self) -> str:
        """Fixpoint engine(s) that served this request."""
        return self._raw.engine

    @property
    def cache_hit(self) -> bool:
        """True iff every plan this request needed was already cached."""
        return self._raw.cache_hit

    @property
    def batch(self) -> int:
        """Microbatch bucket the request rode in."""
        return self._raw.batch

    @property
    def microbatch(self) -> int | None:
        """The serving engine's id of the solve this request rode in (None
        for a UNION request, whose parts each ride alone); riders of one
        solve share it."""
        return self._raw.microbatch

    @property
    def rows(self) -> int:
        """Distinct constant sets solved in the request's microbatch."""
        return self._raw.rows

    @property
    def template_keys(self) -> tuple[str, ...]:
        """Plan-cache template keys (one per union-free part)."""
        return self._raw.template_keys

    @property
    def timings(self) -> dict[str, float]:
        """Per-stage seconds; ``total`` is this request's fair share of
        ``batch_total`` (the whole microbatch wall time)."""
        return self._raw.timings

    @property
    def survivor_mask(self) -> np.ndarray:
        """Raw bool mask over ``snapshot.triples`` (the Sect.-5 output)."""
        return self._raw.survivors

    def raw(self) -> ExecResult:
        """The internal engine record (compat escape hatch, not API)."""
        return self._raw

    # ------------------------------------------------------------------ #
    # bindings: node names, lazily materialized per variable
    # ------------------------------------------------------------------ #
    @property
    def variables(self) -> tuple[str, ...]:
        """The query's variable names, sorted."""
        return tuple(sorted(self._raw.bindings))

    def binding_mask(self, var: str) -> np.ndarray:
        """bool[n_nodes] candidate mask for ``var`` (no materialization)."""
        return self._raw.bindings[var]

    def bindings(self, var: str) -> list[str]:
        """Candidate node *names* for ``var``; computed once, then cached."""
        if var not in self._name_cache:
            names = self._snapshot.node_names
            ids = np.flatnonzero(self._raw.bindings[var])
            self._name_cache[var] = [names[i] for i in ids]
        return self._name_cache[var]

    def binding_count(self, var: str) -> int:
        """Candidate count for ``var`` without materializing names."""
        return int(self._raw.bindings[var].sum())

    # ------------------------------------------------------------------ #
    # survivor triples: iteration + pagination
    # ------------------------------------------------------------------ #
    def _ids(self) -> np.ndarray:
        if self._survivor_ids is None:
            self._survivor_ids = np.flatnonzero(self._raw.survivors)
        return self._survivor_ids

    def __len__(self) -> int:
        """Number of surviving triples."""
        return int(self._ids().shape[0])

    def survivor_triples(
        self, offset: int = 0, limit: int | None = None
    ) -> Iterator[StrTriple]:
        """Yield surviving ``(subject, predicate, object)`` name triples.

        ``offset``/``limit`` paginate over the survivor set in database
        order; only the requested page is ever materialized to names.
        """
        ids = self._ids()
        stop = len(ids) if limit is None else min(len(ids), offset + limit)
        nodes = self._snapshot.node_names
        labels = self._snapshot.label_names
        rows = self._snapshot.triples
        for i in ids[offset:stop]:
            s, p, o = rows[i]
            yield (nodes[s], labels[p], nodes[o])

    def page(self, offset: int = 0, limit: int = 50) -> list[StrTriple]:
        """One pagination page of :meth:`survivor_triples`, as a list."""
        return list(self.survivor_triples(offset=offset, limit=limit))

    def __iter__(self) -> Iterator[StrTriple]:
        return self.survivor_triples()

    def __repr__(self) -> str:
        t = self._raw.timings.get("total", 0.0)
        return (
            f"ResultSet({len(self)}/{self.stats.n_triples} triples survive, "
            f"engine={self.engine}, cache_hit={self.cache_hit}, "
            f"total={t*1e3:.2f}ms)"
        )
