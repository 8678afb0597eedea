"""The port on DBpedia-shaped data under OPTIONAL stars: a small corpus of
the benchmark's ``dbpedia-3m`` shape (all 65,430 predicates, Zipf-sized
predicates and hub nodes, ~20k triples over 6,000 nodes) served through
``GraphDB.query`` and held bit for bit to the benchmark's plain NumPy
reference (``dsbench/reference/dualsim.py``) on every family of the
``dbpedia-serve`` mix; the copy inequalities' span ``solve.copies`` and
counter ``EngineMetrics.copy_ineqs_solved``.  The file imports neither JAX
nor the JAX package."""
import json

import numpy as np
import pytest

from dsbench import harness
from dsbench.data import dbpedia
from dsbench.reference import dualsim as ref
from repro_torch import spans
from repro_torch.core import soi, sparql
from repro_torch.core.graph import Graph
from repro_torch.db import GraphDB

TINY = {"triples": 20_000, "nodes": 6_000}
N_CONSTANTS = 2  # constants tried per family that has a slot


def _json(path):
    with open(path) as f:
        return json.load(f)


CONFIG = _json(harness.BENCH / "configs" / "dbpedia-3m.json")
MIX = _json(harness.BENCH / "traffic" / "dbpedia-serve.json")
FAMILIES = {f["name"]: f for f in MIX["families"]}
BGP = "{ ?s p0 %0 . ?s p1 ?l }"  # F1 without its OPTIONAL


@pytest.fixture(scope="module")
def corpus():
    return dbpedia.generate({**CONFIG, **TINY}, np.random.default_rng(31))


@pytest.fixture(scope="module")
def data(corpus):
    return harness.reference_data(corpus)


@pytest.fixture()
def db(corpus):
    g = Graph.from_arrays(corpus.n_nodes, len(corpus.label_names), corpus.triples.copy())
    g.node_names, g.label_names = list(corpus.node_names), list(corpus.label_names)
    return GraphDB(g, device="cpu")


def _texts(corpus, fam, k=N_CONSTANTS):
    """The family's text with ``k`` constants from its pool: the pool's
    first and its middle node, so the picks do not depend on a stream."""
    if not fam.get("constants"):
        return [fam["text"]]
    pool = corpus.pool(fam["constants"][0])
    picks = [int(pool[0]), int(pool[len(pool) // 2])][:k]
    return [fam["text"].replace("%0", corpus.node_names[c]) for c in picks]


def test_the_corpus_keeps_every_predicate(corpus):
    assert len(corpus.label_names) == CONFIG["predicates"] == 65_430
    assert corpus.label_names[:3] == ["p0", "p1", "p2"]
    sizes = np.bincount(corpus.triples[:, 1], minlength=len(corpus.label_names))
    assert sizes[0] == sizes.max() and sizes[0] > sizes[1] > sizes[2]
    assert 0 < len(corpus.triples) <= TINY["triples"]
    # a hub: the busiest node holds ~1 / H(6000) of the subjects
    top = np.bincount(corpus.triples[:, 0]).max() / len(corpus.triples)
    assert 0.05 < top < 0.15


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_port_equals_the_reference_bit_for_bit(corpus, data, db, family):
    for text in _texts(corpus, FAMILIES[family]):
        rs = db.query(text)
        mask, binds = ref.answer(text, data)
        assert np.array_equal(rs.survivor_mask, mask), text
        assert sorted(rs.variables) == sorted(binds), text
        for var, row in binds.items():
            assert np.array_equal(rs.binding_mask(var), row), (text, var)
        assert rs.engine == "sparse", text


def test_the_families_answer_something(corpus, data):
    # the checks above are not all of empty answers
    found = [int(ref.answer(t, data)[0].sum()) for f in FAMILIES.values()
             for t in _texts(corpus, f, 1)]
    assert sum(n > 0 for n in found) >= 6, found


def _copies(text):
    return len(ref.build(ref.parse(text)).copies)


@pytest.mark.parametrize("riders", [1, 3])
@pytest.mark.parametrize("family", ["F3", "BGP"])
def test_copy_ineqs_solved_counts_sweeps_rows_and_copies(corpus, db, family, riders):
    fam = FAMILIES.get(family, {"text": BGP, "constants": ["objects:p0"]})
    texts = _texts(corpus, fam, 1) * riders
    before = db.stats().copy_ineqs_solved
    results = db.execute_many(texts)
    moved = db.stats().copy_ineqs_solved - before
    r = results[0]
    assert len({x.microbatch for x in results}) == 1
    assert moved == r.sweeps * r.batch * _copies(texts[0])
    assert (moved > 0) == (family != "BGP")
    if family == "F3":
        assert _copies(texts[0]) == 2  # two OPTIONALs on ?s, each v_Q2 <= v


@pytest.fixture()
def tracing():
    spans.drain()
    spans.enable()
    yield
    spans.disable()
    spans.drain()


def test_solve_copies_nests_under_solve_sweeps(corpus, db, tracing):
    text = _texts(corpus, FAMILIES["F3"], 1)[0]
    before = db.stats().stage_seconds
    rs = db.query(text)
    after = db.stats().stage_seconds
    got = spans.drain()
    by_id = {s.id: s for s in got}
    copies = [s for s in got if s.name == "solve.copies"]
    assert len(copies) == rs.sweeps  # one pass a sweep
    for s in copies:
        parent = by_id[s.parent]
        assert parent.name == "solve.sweeps"
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.attrs["copies"] == rs.batch * _copies(text)
        assert s.attrs["rows"] == rs.batch * soi.build_soi(sparql.parse(text)).n_vars
    total = sum(s.seconds for s in copies)
    assert after["solve.copies"] - before.get("solve.copies", 0.0) == pytest.approx(
        total, rel=1e-9)
    sweeps = [s for s in got if s.name == "solve.sweeps"]
    assert total <= sum(s.seconds for s in sweeps)


def test_a_bgp_has_no_copy_pass(corpus, db, tracing):
    db.query(_texts(corpus, {"text": BGP, "constants": ["objects:p0"]}, 1)[0])
    names = {s.name for s in spans.drain()}
    assert "solve.sweeps" in names and "solve.copies" not in names


def test_tracing_off_solve_copies_still_moves(corpus, db):
    spans.disable()
    spans.drain()
    before = db.stats()
    db.query(_texts(corpus, FAMILIES["F1"], 1)[0])
    after = db.stats()
    assert spans.drain() == []
    assert after.stage_seconds["solve.copies"] > before.stage_seconds.get("solve.copies", 0.0)
    assert after.copy_ineqs_solved > before.copy_ineqs_solved


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_mix_parses_in_both_and_holds_an_optional(family):
    text = FAMILIES[family]["text"].replace("%0", "n0")
    assert "OPTIONAL" in text and "UNION" not in text
    q = sparql.parse(text)
    assert sparql.is_union_free(q)
    sys_ = ref.build(ref.parse(text))
    port = soi.build_soi(q)
    assert len(port.copy_ineqs) == len(sys_.copies) > 0
    assert port.n_vars == sys_.n_vars
