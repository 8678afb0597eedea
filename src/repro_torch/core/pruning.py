"""Per-query database pruning (paper Sect. 5, Tables 3-5).

A triple ``(s, a, o)`` of the database *survives* pruning iff some pattern
edge ``(v, a, w)`` of the query's SOI has ``chi[v][s] and chi[w][o]``; all
other triples are irrelevant for any match (Theorems 1/2) and can be dropped
before handing the query to a downstream join processor.

Each pattern edge is evaluated through the snapshot's
:class:`~repro_torch.core.graph.TripleIndex`, from whichever of three sides
holds the fewest triples: those leaving ``v``'s candidates, those entering
``w``'s, or all of label ``a``'s.  After the fixpoint the candidate sets are
mostly small, so a pattern edge reads a few triples where a scan would read
all of them; no side ever holds more than the graph's triples.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np

from .graph import Graph, subgraph_triples
from .soi import SOI


@dataclasses.dataclass
class PruneStats:
    n_triples: int
    n_after: int
    fraction_pruned: float
    per_edge_survivors: list[int]


@dataclasses.dataclass
class PruneVisits:
    """What the :func:`prune_triples` calls inside one :func:`counting` block
    visited: the triple positions they read, and the pattern edges evaluated
    from each side (those whose label the graph lacks read nothing and count
    on no side)."""

    triples: int = 0
    by_subject: int = 0  # from the triples leaving the subject's candidates
    by_object: int = 0  # from the triples entering the object's candidates
    by_label: int = 0  # from all the triples of the edge's label


_local = threading.local()


@contextlib.contextmanager
def counting():
    """Count what this thread's :func:`prune_triples` calls visit inside the
    block, into the :class:`PruneVisits` it yields (a nested block counts its
    own calls only)."""
    outer = getattr(_local, "visits", None)
    _local.visits = visits = PruneVisits()
    try:
        yield visits
    finally:
        _local.visits = outer


def _ranges(lo: np.ndarray, deg: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """``pos[lo[i]:lo[i] + deg[i]]`` for every ``i``, concatenated."""
    ends = np.cumsum(deg)
    return pos[np.repeat(lo - (ends - deg), deg) + np.arange(ends[-1] if len(ends) else 0)]


def prune_triples(
    soi: SOI, chi: np.ndarray, g: Graph
) -> tuple[np.ndarray, PruneStats]:
    """Boolean survivor mask over ``g.triples`` plus stats."""
    ix = g.triple_index()
    triples = g.triples
    mask = np.zeros(g.n_edges, dtype=bool)
    per_edge = []
    rows: dict[int, np.ndarray] = {}
    # per variable: its candidates' first position and degree, out and in
    out_of: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    in_of: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def row(v: int) -> np.ndarray:
        if v not in rows:
            rows[v] = np.asarray(chi[v], dtype=bool)
        return rows[v]

    def runs(v: int, ptr: np.ndarray, memo: dict) -> tuple[np.ndarray, np.ndarray]:
        if v not in memo:
            c = np.flatnonzero(row(v))
            lo = ptr[c]
            memo[v] = lo, ptr[c + 1] - lo
        return memo[v]

    visits = getattr(_local, "visits", None)
    for v, a, w in soi.pattern_edges:
        if isinstance(a, str):
            la = g.label_index().get(a) if g.label_names is not None else None
        else:
            la = int(a) if 0 <= int(a) < g.n_labels else None
        if la is None:
            per_edge.append(0)
            continue
        lo_v, deg_v = runs(v, ix.ptr_s, out_of)
        lo_w, deg_w = runs(w, ix.ptr_o, in_of)
        costs = (int(deg_v.sum()), int(deg_w.sum()), int(ix.ptr_l[la + 1] - ix.ptr_l[la]))
        side = costs.index(min(costs))
        if side == 0:
            pos = _ranges(lo_v, deg_v, ix.pos_s)
            t = triples[pos]
            hit = (t[:, 1] == la) & row(w)[t[:, 2]]
        elif side == 1:
            pos = _ranges(lo_w, deg_w, ix.pos_o)
            t = triples[pos]
            hit = (t[:, 1] == la) & row(v)[t[:, 0]]
        else:
            pos = ix.pos_l[ix.ptr_l[la] : ix.ptr_l[la + 1]]
            t = triples[pos]
            hit = row(v)[t[:, 0]] & row(w)[t[:, 2]]
        kept = pos[hit]
        mask[kept] = True
        per_edge.append(len(kept))
        if visits is not None:
            visits.triples += costs[side]
            visits.by_subject += side == 0
            visits.by_object += side == 1
            visits.by_label += side == 2
    n_after = int(np.count_nonzero(mask))
    return mask, PruneStats(
        n_triples=g.n_edges,
        n_after=n_after,
        fraction_pruned=1.0 - n_after / max(g.n_edges, 1),
        per_edge_survivors=per_edge,
    )


def pruned_graph(soi: SOI, chi: np.ndarray, g: Graph) -> tuple[Graph, PruneStats]:
    mask, stats = prune_triples(soi, chi, g)
    return subgraph_triples(g, mask), stats
