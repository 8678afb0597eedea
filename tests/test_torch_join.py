"""The paper's downstream evaluators in the port against the JAX package:
the hash-join SPARQL evaluator (``core/join.py``, Tables 4/5) and the two
rival dual-simulation algorithms, HHK (``core/hhk.py``) and Ma et al.
(``core/ma_baseline.py``, Table 2).  All numpy: the bar is exact
equality of the deduplicated bindings, of the relation and of the pass
counts; both rivals are also held against the port's own ``sparse``
engine on the CPU, and the join results against the port's pruning."""
import numpy as np
import pytest

from repro.core import join as ref_join
from repro.core import sparql as ref_sparql
from repro.core.hhk import dual_simulation_hhk as ref_hhk
from repro.core.ma_baseline import dual_simulation_ma as ref_ma
from repro.data import synth as ref_synth
from repro_torch.core import dualsim, join, pruning, soi, sparql
from repro_torch.core.graph import Graph, subgraph_triples
from repro_torch.core.hhk import dual_simulation_hhk
from repro_torch.core.ma_baseline import dual_simulation_ma
from repro_torch.data import synth


def _same(got, want):
    assert sorted(got.cols) == sorted(want.cols)
    assert got.n_rows == want.n_rows
    for name in got.cols:
        assert got.cols[name].dtype == want.cols[name].dtype
        assert np.array_equal(got.cols[name], want.cols[name]), name


def _both(text, g_port, g_ref, **kw):
    got = join.evaluate(sparql.parse(text), g_port, **kw)
    want = ref_join.evaluate(ref_sparql.parse(text), g_ref, **kw)
    _same(got, want)
    return got


# --------------------------------------------------------------------- #
# tests/test_join.py's cases, through both packages
# --------------------------------------------------------------------- #
_TRIPLES = [("a1", "knows", "b1"), ("a2", "knows", "b2"), ("b1", "likes", "c1")]

JOIN_CASES = [
    ("{ ?x knows ?y . ?y likes ?z }", 1),
    ("{ ?x knows ?y } OPTIONAL { ?y likes ?z }", 2),
    ("{ ?x knows ?y } UNION { ?x likes ?y }", 3),
    ("{ ?x knows ?y } AND { ?x knows ?y }", 2),
    ("{ { ?x knows ?y } OPTIONAL { ?y likes ?z } } AND { ?z2 likes ?z }", 2),
    ("{ ?x knows b2 }", 1),
    ("{ ?x owns ?y }", 0),
]


@pytest.mark.parametrize("order", ["selectivity", "syntactic"])
@pytest.mark.parametrize("text,rows", JOIN_CASES)
def test_reference_join_cases(text, rows, order):
    from repro.core.graph import Graph as RefGraph

    g, g_ref = Graph.from_triples(_TRIPLES), RefGraph.from_triples(_TRIPLES)
    m = _both(text, g, g_ref, join_order=order)
    assert m.n_rows == rows


def test_optional_leaves_unbound_and_required_triples():
    from repro.core.graph import Graph as RefGraph

    g, g_ref = Graph.from_triples(_TRIPLES), RefGraph.from_triples(_TRIPLES)
    m = _both("{ ?x knows ?y } OPTIONAL { ?y likes ?z }", g, g_ref)
    assert (m.cols["z"] == -1).sum() == 1  # a2/b2 row has no likes
    m = _both("{ ?x knows b2 }", g, g_ref)
    assert g.node_names[m.cols["x"][0]] == "a2"
    text = "{ ?x knows ?y . ?y likes ?z }"
    m = join.evaluate(sparql.parse(text), g)
    want = ref_join.evaluate(ref_sparql.parse(text), g_ref)
    assert join.required_triples(sparql.parse(text), g, m) == 2
    assert ref_join.required_triples(ref_sparql.parse(text), g_ref, want) == 2


# --------------------------------------------------------------------- #
# random graphs and queries
# --------------------------------------------------------------------- #
RANDOM_QUERIES = [
    "{ ?a p0 ?b . ?b p1 ?c }",
    "{ ?a p0 ?b . ?b p0 ?a }",
    "{ ?a p0 ?b } OPTIONAL { ?b p1 ?c }",
    "{ { ?a p0 ?b } OPTIONAL { ?b p1 ?c } } OPTIONAL { ?c p2 ?d }",
    "{ ?a p0 ?b } UNION { ?a p2 ?b }",
    "{ { ?a p1 ?b } UNION { ?a p2 ?b } } AND { ?b p0 ?c }",
    "{ ?a p0 ?a }",
    "{ ?a p0 n3 . ?a p1 ?b }",
    "{ ?a p3 ?b . ?b p3 ?c . ?c p3 ?a }",
]
WELL_DESIGNED = RANDOM_QUERIES[:4] + RANDOM_QUERIES[6:]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", ["selectivity", "syntactic"])
def test_random_graphs_and_queries(seed, order):
    g = synth.dbpedia_like(n_nodes=40, n_labels=5, n_edges=160, seed=seed)
    g_ref = ref_synth.dbpedia_like(n_nodes=40, n_labels=5, n_edges=160, seed=seed)
    assert np.array_equal(g.triples, g_ref.triples)
    for text in RANDOM_QUERIES:
        _both(text, g, g_ref, join_order=order)


def _pruned(q, g):
    """The graph pruned by the port's own ``sparse`` engine on the CPU."""
    mask = np.zeros(g.n_edges, dtype=bool)
    for part in sparql.union_split(q):
        s = soi.build_soi(part)
        chi, _ = dualsim.solve_compiled(soi.compile_soi(s, g), g, engine="sparse",
                                        device="cpu")
        mask |= pruning.prune_triples(s, chi, g)[0]
    return subgraph_triples(g, mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pruning_keeps_every_match(seed):
    """Theorems 1/2 in the port: on the graph its own engine pruned, every
    well-designed query has the same bindings as on the full graph."""
    g = synth.dbpedia_like(n_nodes=40, n_labels=5, n_edges=160, seed=seed)
    for text in WELL_DESIGNED:
        q = sparql.parse(text)
        _same(join.evaluate(q, _pruned(q, g)), join.evaluate(q, g))


def test_lubm_queries_full_and_pruned():
    g = synth.lubm_like(n_universities=2, seed=0)
    g_ref = ref_synth.lubm_like(n_universities=2, seed=0)
    for q in (synth.lubm_l0_like(), synth.lubm_l1_like(), synth.optional_query()):
        text = sparql.format_query(q)
        full = _both(text, g, g_ref)
        _same(join.evaluate(q, _pruned(q, g)), full)


# --------------------------------------------------------------------- #
# the rival dual-simulation algorithms
# --------------------------------------------------------------------- #
def _instance(seed):
    """``tests/test_dualsim_core.py``'s random pattern and database."""
    rng = np.random.default_rng(seed)
    n_labels = int(rng.integers(1, 4))
    kw_p = dict(n_vars=int(rng.integers(2, 5)), n_labels=n_labels,
                n_edges=int(rng.integers(1, 7)), seed=seed)
    kw_d = dict(n_nodes=int(rng.integers(3, 40)), n_labels=n_labels,
                n_edges=int(rng.integers(5, 120)), seed=seed + 1)
    return (synth.random_pattern(**kw_p), synth.random_graph(**kw_d),
            ref_synth.random_pattern(**kw_p), ref_synth.random_graph(**kw_d))


@pytest.mark.parametrize("seed", range(8))
def test_rivals_match_reference_and_sparse(seed):
    pat, db, ref_pat, ref_db = _instance(seed)
    s_ma, passes = dual_simulation_ma(pat, db)
    s_hhk, pops = dual_simulation_hhk(pat, db)
    want_ma, want_passes = ref_ma(ref_pat, ref_db)
    want_hhk, want_pops = ref_hhk(ref_pat, ref_db)
    assert np.array_equal(s_ma, want_ma) and passes == want_passes
    assert np.array_equal(s_hhk, want_hhk) and pops == want_pops
    s, _ = dualsim.largest_dual_simulation(pat, db, engine="sparse", device="cpu")
    assert np.array_equal(s_ma, s) and np.array_equal(s_hhk, s)
