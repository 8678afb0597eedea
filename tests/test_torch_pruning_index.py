"""Pruning through the snapshot's triple index against the JAX package's
full scan: equal survivor masks and ``PruneStats`` on seeded random graphs
(self-loops, empty and full candidate rows, labels by name, by id and
unknown, constants at either end), each pattern edge read from the side the
counters say, and the index itself: its sizes and orders, one build per
snapshot however many threads reach it, and a fresh index after a
mutation."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

from repro.core import graph as ref_graph
from repro.core import pruning as ref_pruning
from repro.core import soi as ref_soi
from repro.data import synth as ref_synth
from repro.db import GraphDB as RefGraphDB
from repro_torch.core import graph, pruning, soi
from repro_torch.data import synth
from repro_torch.db import GraphDB

N_NODES, N_LABELS, N_EDGES = 300, 12, 4000


def _graphs(seed):
    """The same dbpedia-shaped graph with a self-loop of every 7th node
    (labels 0 and 1), in both packages."""
    g = synth.dbpedia_like(N_NODES, N_LABELS, N_EDGES, seed=seed)
    loops = np.arange(0, N_NODES, 7, dtype=np.int32)
    extra = np.stack([loops, loops % 2, loops], axis=1).astype(np.int32)
    triples = np.vstack([g.triples, extra])
    port = graph.Graph(g.n_nodes, g.n_labels, triples, g.node_names, g.label_names)
    ref = ref_graph.Graph(g.n_nodes, g.n_labels, triples.copy(), list(g.node_names),
                          list(g.label_names))
    return port, ref


def _sois(n_vars, edges):
    """One SOI in each package whose pattern edges are ``edges``."""
    def make(mod):
        return mod.SOI(base=[f"v{i}" for i in range(n_vars)], is_const=[None] * n_vars,
                       edge_ineqs=[], copy_ineqs=[], pattern_edges=list(edges),
                       external_mand={}, external_opt={})
    return make(soi), make(ref_soi)


def _chi(rng, n_vars, kinds):
    """Candidate rows: ``full`` (the Eq.-13 init), ``empty``, ``one`` (a
    constant), ``few`` (a handful) or ``half``."""
    chi = np.zeros((n_vars, N_NODES), dtype=bool)
    for v, kind in enumerate(kinds):
        if kind == "full":
            chi[v] = True
        elif kind == "one":
            chi[v, rng.integers(N_NODES)] = True
        elif kind == "few":
            chi[v, rng.choice(N_NODES, 5, replace=False)] = True
        elif kind == "half":
            chi[v] = rng.random(N_NODES) < 0.5
    return chi


def _same_as_reference(g, rg, edges, chi):
    s, rs = _sois(chi.shape[0], edges)
    with pruning.counting() as visits:
        mask, stats = pruning.prune_triples(s, chi, g)
    rmask, rstats = ref_pruning.prune_triples(rs, chi, rg)
    assert mask.dtype == rmask.dtype and np.array_equal(mask, rmask)
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
    return visits


def _cost(g, v, a, w, chi):
    """What each side of pattern edge ``(v, a, w)`` holds, counted from the
    triples without the index: (subject, object, label)."""
    t = g.triples
    return (int(chi[v][t[:, 0]].sum()), int(chi[w][t[:, 2]].sum()), int((t[:, 1] == a).sum()))


KINDS = ["full", "empty", "one", "few", "half"]
EDGES = [
    [(0, "p0", 1)],
    [(0, "p1", 0)],  # ?x p ?x over the self-loops
    [(0, "p0", 1), (1, "p3", 2), (2, 5, 0)],  # names and ids
    [(0, "noSuchLabel", 1), (0, "p2", 1)],
    [(0, "p0", 0), (0, "p1", 1), (1, "p2", 1)],
    [(0, 999, 1), (0, -1, 1), (1, "p11", 0)],  # ids the graph lacks
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", range(len(EDGES)))
def test_masks_and_stats_equal_the_full_scan(seed, case):
    g, rg = _graphs(seed)
    rng = np.random.default_rng(seed * 100 + case)
    edges = EDGES[case]
    n_vars = 1 + max(max(v, w) for v, _, w in edges)
    for kinds in ([k] * n_vars for k in KINDS):
        chi = _chi(rng, n_vars, kinds)
        visits = _same_as_reference(g, rg, edges, chi)
        resolved = [(v, g.label_id(a) if isinstance(a, str) else a, w) for v, a, w in edges
                    if (a in g.label_names if isinstance(a, str) else 0 <= a < N_LABELS)]
        assert visits.triples == sum(min(_cost(g, v, a, w, chi)) for v, a, w in resolved)
        assert visits.by_subject + visits.by_object + visits.by_label == len(resolved)
    for _ in range(6):  # mixed rows
        chi = _chi(rng, n_vars, rng.choice(KINDS, n_vars))
        _same_as_reference(g, rg, edges, chi)


@pytest.mark.parametrize("seed", [0, 3])
def test_constants_at_either_end(seed):
    g, rg = _graphs(seed)
    rng = np.random.default_rng(seed)
    edges = [(0, "p0", 1), (1, "p1", 2), (3, "p2", 0)]  # 2 and 3: constant rows
    for const in (2, 3):
        kinds = ["half", "half", "full", "full"]
        kinds[const] = "one"
        _same_as_reference(g, rg, edges, _chi(rng, 4, kinds))


@pytest.mark.parametrize("side,kinds,label", [
    ("by_subject", ["one", "full"], "p0"),  # a constant subject: its few out triples
    ("by_object", ["full", "one"], "p0"),  # a constant object: its few in triples
    ("by_label", ["full", "full"], "p11"),  # both ends full, the rarest label
])
def test_each_side_is_taken_where_it_holds_fewest(side, kinds, label):
    g, rg = _graphs(0)
    chi = _chi(np.random.default_rng(5), 2, kinds)
    visits = _same_as_reference(g, rg, [(0, label, 1)], chi)
    assert getattr(visits, side) == 1
    assert visits.by_subject + visits.by_object + visits.by_label == 1
    assert visits.triples == min(_cost(g, 0, g.label_id(label), 1, chi)) < g.n_edges


def test_no_counting_outside_a_block_and_nested_blocks_count_their_own():
    g, _ = _graphs(0)
    s, _ = _sois(2, [(0, "p0", 1)])
    chi = np.ones((2, N_NODES), dtype=bool)
    pruning.prune_triples(s, chi, g)  # outside any block: nothing to count into
    with pruning.counting() as outer:
        pruning.prune_triples(s, chi, g)
        with pruning.counting() as inner:
            pruning.prune_triples(s, chi, g)
            pruning.prune_triples(s, chi, g)
    assert inner.by_label == 2 and outer.by_label == 1
    assert inner.triples == 2 * outer.triples


def test_index_sizes_and_orders():
    g, _ = _graphs(1)
    ix = g.triple_index()
    assert g.triple_index() is ix
    n, e, labels = g.n_nodes, g.n_edges, g.n_labels
    for ptr, pos, col, size in ((ix.ptr_s, ix.pos_s, 0, n), (ix.ptr_o, ix.pos_o, 2, n),
                                (ix.ptr_l, ix.pos_l, 1, labels)):
        assert ptr.shape == (size + 1,) and ptr.dtype == np.int64
        assert pos.shape == (e,) and pos.dtype == np.int32
        assert ptr[0] == 0 and ptr[-1] == e
        assert np.array_equal(np.sort(pos), np.arange(e))
        keys = g.triples[pos, col]
        assert np.array_equal(keys, np.sort(keys, kind="stable"))
        for u in (0, 7, size - 1):  # each key's run holds its triples, in order
            run = pos[ptr[u]:ptr[u + 1]]
            assert np.array_equal(run, np.flatnonzero(g.triples[:, col] == u))


def test_threads_reaching_the_first_prune_build_one_index(monkeypatch):
    g, rg = _graphs(2)
    builds = []
    build = graph.TripleIndex.build

    def slow_build(snapshot):
        builds.append(snapshot)
        time.sleep(0.05)  # hold the build open while the others arrive
        return build(snapshot)

    monkeypatch.setattr(graph.TripleIndex, "build", staticmethod(slow_build))
    s, rs = _sois(2, [(0, "p0", 1), (1, "p1", 0)])
    chi = _chi(np.random.default_rng(2), 2, ["few", "half"])
    want, _ = ref_pruning.prune_triples(rs, chi, rg)
    n = 8
    start = threading.Barrier(n)
    got = [None] * n

    def worker(i):
        start.wait(timeout=10)
        got[i] = pruning.prune_triples(s, chi, g)[0]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and builds[0] is g
    assert all(m is not None and np.array_equal(m, want) for m in got)


def test_a_mutation_gives_the_next_snapshot_its_own_index():
    db = GraphDB(synth.lubm_like(2, seed=0), device="cpu", engine="sparse")
    ref = RefGraphDB(ref_synth.lubm_like(2, seed=0), engine="sparse")
    q = "{ ?d subOrganizationOf Univ0 . ?s memberOf ?d }"
    assert np.array_equal(db.query(q).survivor_mask, ref.query(q).survivor_mask)
    first = db.graph
    ix = first.triple_index()
    g = first
    row = g.triples[int(np.flatnonzero(g.triples[:, 1] == g.label_id("memberOf"))[0])]
    t = (g.node_names[row[0]], g.label_names[row[1]], g.node_names[row[2]])
    new = ("Student_new", "memberOf", g.node_names[row[2]])
    for mutate, triples in (("delete", [t]), ("insert", [t, new])):
        before = db.graph
        assert getattr(db, mutate)(triples) == getattr(ref, mutate)(triples) > 0
        assert db.graph is not before and db.graph._triple_index is None
        rs = db.query(q)
        assert np.array_equal(rs.survivor_mask, ref.query(q).survivor_mask)
        assert rs.stats.per_edge_survivors == ref.query(q).stats.per_edge_survivors
        now = db.graph.triple_index()
        assert now is not before.triple_index()
        assert now.pos_s.shape == (db.graph.n_edges,)
        assert now.ptr_s.shape == (db.graph.n_nodes + 1,)
    assert first.triple_index() is ix  # the old snapshot keeps its own
