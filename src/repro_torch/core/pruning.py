"""Per-query database pruning (paper Sect. 5, Tables 3-5).

A triple ``(s, a, o)`` of the database *survives* pruning iff some pattern
edge ``(v, a, w)`` of the query's SOI has ``chi[v][s] and chi[w][o]``; all
other triples are irrelevant for any match (Theorems 1/2) and can be dropped
before handing the query to a downstream join processor.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Graph, subgraph_triples
from .soi import SOI


@dataclasses.dataclass
class PruneStats:
    n_triples: int
    n_after: int
    fraction_pruned: float
    per_edge_survivors: list[int]


def prune_triples(
    soi: SOI, chi: np.ndarray, g: Graph
) -> tuple[np.ndarray, PruneStats]:
    """Boolean survivor mask over ``g.triples`` plus stats."""
    mask = np.zeros(g.n_edges, dtype=bool)
    per_edge = []
    label_of = g.triples[:, 1]
    s_of = g.triples[:, 0]
    o_of = g.triples[:, 2]
    for v, a, w in soi.pattern_edges:
        if isinstance(a, str):
            la = g.label_index().get(a) if g.label_names is not None else None
            if la is None:
                per_edge.append(0)
                continue
        else:
            la = int(a)
        sel = label_of == la
        hit = sel & chi[v][s_of] & chi[w][o_of]
        per_edge.append(int(hit.sum()))
        mask |= hit
    n_after = int(mask.sum())
    return mask, PruneStats(
        n_triples=g.n_edges,
        n_after=n_after,
        fraction_pruned=1.0 - n_after / max(g.n_edges, 1),
        per_edge_survivors=per_edge,
    )


def triples_scanned(soi: SOI, g: Graph) -> int:
    """The triples whose membership :func:`prune_triples` evaluates: all of
    ``g``'s for each pattern edge whose label ``g`` holds."""
    labels = g.label_index() if g.label_names is not None else {}
    edges = sum(1 for _, a, _ in soi.pattern_edges if not isinstance(a, str) or a in labels)
    return edges * g.n_edges


def pruned_graph(soi: SOI, chi: np.ndarray, g: Graph) -> tuple[Graph, PruneStats]:
    mask, stats = prune_triples(soi, chi, g)
    return subgraph_triples(g, mask), stats
