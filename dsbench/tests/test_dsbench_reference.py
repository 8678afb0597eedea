"""The NumPy reference against the port on the CPU, on every template family
of the three mixes, OPTIONAL included, and on the SOI rules' corner cases."""
import numpy as np
import pytest

from dsbench import harness
from dsbench.reference import dualsim as ref
from dsbench.tests._tiny import tiny_cell

CELLS = ("lubm30.serve", "lubm30.adhoc")


def _db(corpus):
    from repro_torch.core.graph import Graph
    from repro_torch.db import GraphDB

    g = Graph.from_arrays(corpus.n_nodes, len(corpus.label_names), corpus.triples.copy())
    g.node_names, g.label_names = list(corpus.node_names), list(corpus.label_names)
    return GraphDB(g, device="cpu")


def _families(requests, per_family=2):
    seen: dict[str, int] = {}
    for fam, text in requests.window:
        if seen.get(fam, 0) < per_family:
            seen[fam] = seen.get(fam, 0) + 1
            yield fam, text


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port(name):
    from repro_torch.core import soi

    cell = tiny_cell(name)
    corpus, requests, _, _ = harness.make_inputs(cell, 21)
    data = harness.reference_data(corpus)
    db = _db(corpus)
    fams = set()
    for fam, text in _families(requests):
        fams.add(fam)
        rs = db.query(text)
        mask, binds = ref.answer(text, data)
        assert np.array_equal(rs.survivor_mask, mask), (fam, text)
        assert sorted(rs.variables) == sorted(binds), (fam, text)
        for v in binds:
            assert np.array_equal(rs.binding_mask(v), binds[v]), (fam, text, v)
        # the K1 byte count reads the reference's SOI: it must have the
        # port's variables and labels
        from repro_torch.core import sparql
        port = soi.build_soi(sparql.parse(text))
        mine = ref.build(ref.parse(text))
        assert port.n_vars == mine.n_vars, text
        assert sorted({a for _, a, _ in port.pattern_edges}) == sorted(mine.operators())
    assert len(fams) == len({f for f, _ in requests.window[:512]})


CORNERS = [
    "{ { ?x p0 ?y } OPTIONAL { ?y p1 ?z } }",
    "{ { { ?x p0 ?y } OPTIONAL { ?y p1 ?z } } OPTIONAL { ?z p2 ?w } }",
    "{ { ?x p0 ?y } OPTIONAL { { ?y p1 ?z } OPTIONAL { ?z p0 ?x } } }",
    "{ { { ?x p0 ?y } OPTIONAL { ?x p1 ?z } } AND { { ?y p2 ?w } OPTIONAL { ?x p1 ?z } } }",
    "{ { ?x p0 n3 . ?x p1 ?y } OPTIONAL { ?y p2 ?z . n3 p0 ?z } }",
    "{ { ?x p0 ?y } AND { ?y p1 ?z } AND { ?z p2 ?x } }",
    "{ ?x p0 ?x }",
    "{ ?x p9 ?y }",
    "{ ?x p0 nowhere }",
]


@pytest.mark.parametrize("text", CORNERS)
def test_reference_soi_rules(text):
    from repro_torch.core.graph import Graph
    from repro_torch.db import GraphDB

    rng = np.random.default_rng(2)
    n, labels = 40, ["p0", "p1", "p2"]
    t = np.stack([rng.integers(0, n, 150), rng.integers(0, 3, 150), rng.integers(0, n, 150)], 1)
    t = np.unique(t, axis=0).astype(np.int32)
    names = [f"n{i}" for i in range(n)]
    g = Graph.from_arrays(n, 3, t.copy())
    g.node_names, g.label_names = list(names), list(labels)
    rs = GraphDB(g, device="cpu").query(text)
    data = ref.Data(t, n, {m: i for i, m in enumerate(names)}, {m: i for i, m in enumerate(labels)})
    mask, binds = ref.answer(text, data)
    assert np.array_equal(rs.survivor_mask, mask)
    for v in binds:
        assert np.array_equal(rs.binding_mask(v), binds[v]), v
