"""The port's framework-free front end against the JAX package: the same
graphs from ``synth`` and ``rdf``, the same parse -> ``format_query`` round
trip, the same ``CompiledSOI`` arrays and the same pruning statistics."""
import dataclasses

import numpy as np
import pytest

from repro.core import pruning as ref_pruning
from repro.core import soi as ref_soi
from repro.core import sparql as ref_sparql
from repro.data import rdf as ref_rdf
from repro.data import synth as ref_synth
from repro_torch.core import pruning, soi, sparql
from repro_torch.data import rdf, synth

QUERIES = [
    "{ ?d subOrganizationOf Univ0 . ?s memberOf ?d }",
    "{ ?x memberOf ?y . ?y subOrganizationOf ?z . ?x undergraduateDegreeFrom ?z }",
    "{ ?s memberOf ?d } OPTIONAL { ?s advisor ?a }",
    "{ ?s memberOf ?d . ?d subOrganizationOf ?u } OPTIONAL "
    "{ { ?s advisor ?a } OPTIONAL { ?p publicationAuthor ?s } }",
    "{ { ?s memberOf ?d } UNION { ?s worksFor ?d } } AND "
    "{ ?d subOrganizationOf Univ1 }",
    "{ ?p publicationAuthor ?s . ?p publicationAuthor ?f . ?f worksFor ?d }",
    "{ ?s memberOf Dept0_0 } AND { ?s noSuchLabel ?x }",
]


def _same_graph(a, b):
    assert (a.n_nodes, a.n_labels) == (b.n_nodes, b.n_labels)
    assert a.triples.dtype == b.triples.dtype
    assert np.array_equal(a.triples, b.triples)
    assert a.node_names == b.node_names and a.label_names == b.label_names


@pytest.mark.parametrize("seed", [0, 3])
def test_lubm_like_same_graph(seed):
    _same_graph(synth.lubm_like(3, seed=seed), ref_synth.lubm_like(3, seed=seed))


def test_lubm_stream_same_triples():
    assert list(synth.lubm_stream(4, seed=2)) == list(
        ref_synth.lubm_stream(4, seed=2)
    )


def test_random_graph_and_pattern_same():
    _same_graph(synth.random_graph(50, 3, 200, seed=4),
                ref_synth.random_graph(50, 3, 200, seed=4))
    a = synth.random_pattern(4, 3, 6, seed=4)
    b = ref_synth.random_pattern(4, 3, 6, seed=4)
    assert np.array_equal(a.triples, b.triples)


def test_rdf_stream_round_trip_same_graph(tmp_path):
    path = str(tmp_path / "lubm.nt")
    n = rdf.dump_stream(synth.lubm_stream(3, seed=1), path)
    assert n == ref_rdf.dump_stream(ref_synth.lubm_stream(3, seed=1),
                                    str(tmp_path / "ref.nt"))
    assert (tmp_path / "lubm.nt").read_text() == (tmp_path / "ref.nt").read_text()
    _same_graph(rdf.load_stream(path, chunk_triples=97),
                ref_rdf.load_stream(path, chunk_triples=97))


@pytest.mark.parametrize("text", QUERIES)
def test_parse_format_round_trip_same(text):
    q, rq = sparql.parse(text), ref_sparql.parse(text)
    out = sparql.format_query(q)
    assert out == ref_sparql.format_query(rq)
    assert sparql.parse(out) == q
    assert [sparql.format_query(p) for p in sparql.union_split(q)] == [
        ref_sparql.format_query(p) for p in ref_sparql.union_split(rq)
    ]


@pytest.mark.parametrize("text", QUERIES)
def test_compiled_soi_and_prune_stats_same(text):
    g, rg = synth.lubm_like(3, seed=0), ref_synth.lubm_like(3, seed=0)
    for part, rpart in zip(sparql.union_split(sparql.parse(text)),
                           ref_sparql.union_split(ref_sparql.parse(text))):
        s, rs = soi.build_soi(part), ref_soi.build_soi(rpart)
        assert dataclasses.asdict(s) == dataclasses.asdict(rs)
        c, rc = soi.compile_soi(s, g), ref_soi.compile_soi(rs, rg)
        assert c.mats == rc.mats and c.n_vars == rc.n_vars
        for name in ("init", "ineq_lhs", "ineq_rhs", "ineq_mat",
                     "copy_lhs", "copy_rhs"):
            x, y = getattr(c, name), getattr(rc, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        # pruning over a fixed candidate relation: the Eq.-13 init
        mask, stats = pruning.prune_triples(s, c.init, g)
        rmask, rstats = ref_pruning.prune_triples(rs, rc.init, rg)
        assert np.array_equal(mask, rmask)
        assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)
        got, ref = soi.collect(s, c.init), ref_soi.collect(rs, rc.init)
        assert got.keys() == ref.keys()
        assert all(np.array_equal(got[k], ref[k]) for k in got)
