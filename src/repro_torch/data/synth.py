"""Synthetic graph databases and query workloads.

* :func:`lubm_like` — a scaled-down LUBM generator (universities,
  departments, professors, students, publications) with the benchmark's
  characteristic low label diversity (~18 predicates over a dense instance
  graph), which is exactly the regime where the paper's L0/L1 iteration
  behaviour shows (Sect. 5.3).
* :func:`lubm_stream` — the same schema as a one-triple-at-a-time
  generator with O(department) live state, feeding the streaming RDF
  ingest at node counts where the dense [n, n] tier cannot exist
  (DESIGN.md 12.5).
* :func:`dbpedia_like` — heterogeneous labels with Zipfian selectivity,
  mimicking DBpedia's high-selectivity predicates.
* :func:`random_graph` / :func:`random_pattern` — property-test fodder.
* Query builders for the paper's L0/L1 shapes (cyclic, low-selectivity).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.sparql import Optional_, Query, bgp_of_triples

LUBM_PREDICATES = [
    "type", "memberOf", "subOrganizationOf", "undergraduateDegreeFrom",
    "worksFor", "advisor", "publicationAuthor", "teacherOf",
    "takesCourse", "headOf", "degreeFrom", "mastersDegreeFrom",
    "doctoralDegreeFrom", "researchInterest", "emailAddress", "telephone",
    "name", "teachingAssistantOf",
]


def lubm_like(
    n_universities: int = 3,
    depts_per_uni: int = 4,
    profs_per_dept: int = 5,
    students_per_dept: int = 20,
    pubs_per_prof: int = 3,
    seed: int = 0,
) -> Graph:
    rng = np.random.default_rng(seed)
    triples: list[tuple[str, str, str]] = []
    unis, depts, profs, students, pubs = [], [], [], [], []
    for u in range(n_universities):
        uni = f"Univ{u}"
        unis.append(uni)
        for d in range(depts_per_uni):
            dept = f"Dept{u}_{d}"
            depts.append(dept)
            triples.append((dept, "subOrganizationOf", uni))
            dept_profs = []
            for p in range(profs_per_dept):
                prof = f"Prof{u}_{d}_{p}"
                profs.append(prof)
                dept_profs.append(prof)
                triples.append((prof, "worksFor", dept))
                triples.append(
                    (prof, "degreeFrom", unis[rng.integers(0, len(unis))])
                )
                for k in range(pubs_per_prof):
                    pub = f"Pub{u}_{d}_{p}_{k}"
                    pubs.append(pub)
                    triples.append((pub, "publicationAuthor", prof))
            for s in range(students_per_dept):
                st = f"Student{u}_{d}_{s}"
                students.append(st)
                triples.append((st, "memberOf", dept))
                adv = dept_profs[rng.integers(0, len(dept_profs))]
                triples.append((st, "advisor", adv))
                triples.append(
                    (st, "undergraduateDegreeFrom", unis[rng.integers(0, len(unis))])
                )
                # some students co-author with their advisor's publications
                if rng.random() < 0.4 and pubs:
                    triples.append(
                        (pubs[rng.integers(0, len(pubs))], "publicationAuthor", st)
                    )
    return Graph.from_triples(triples)


def lubm_stream(
    n_universities: int,
    depts_per_uni: int = 4,
    profs_per_dept: int = 5,
    students_per_dept: int = 20,
    pubs_per_prof: int = 3,
    seed: int = 0,
):
    """LUBM-shaped triples as a *generator* — the RDF-scale workload source
    (DESIGN.md 12.5).

    Same entity schema and predicate mix as :func:`lubm_like`, but yields
    ``(s, p, o)`` string triples one at a time with O(department) live
    state: degree edges target a uniform university id (names are
    deterministic, no list needed) and student co-authorship picks a
    department-local publication.  Pipe into
    :func:`repro_torch.data.rdf.dump_stream` / :func:`~repro_torch.data.rdf.load_stream`
    to ingest node counts where the dense [n, n] tier cannot exist without
    ever materializing a tuple-per-triple list.
    """
    rng = np.random.default_rng(seed)
    for u in range(n_universities):
        uni = f"Univ{u}"
        for d in range(depts_per_uni):
            dept = f"Dept{u}_{d}"
            yield dept, "subOrganizationOf", uni
            dept_pubs: list[str] = []
            for p in range(profs_per_dept):
                prof = f"Prof{u}_{d}_{p}"
                yield prof, "worksFor", dept
                deg = f"Univ{rng.integers(0, n_universities)}"
                yield prof, "degreeFrom", deg
                for k in range(pubs_per_prof):
                    pub = f"Pub{u}_{d}_{p}_{k}"
                    dept_pubs.append(pub)
                    yield pub, "publicationAuthor", prof
            for s in range(students_per_dept):
                st = f"Student{u}_{d}_{s}"
                yield st, "memberOf", dept
                adv = f"Prof{u}_{d}_{rng.integers(0, profs_per_dept)}"
                yield st, "advisor", adv
                deg = f"Univ{rng.integers(0, n_universities)}"
                yield st, "undergraduateDegreeFrom", deg
                if rng.random() < 0.4 and dept_pubs:
                    pub = dept_pubs[rng.integers(0, len(dept_pubs))]
                    yield pub, "publicationAuthor", st


def dbpedia_like(
    n_nodes: int = 2000, n_labels: int = 40, n_edges: int = 10_000, seed: int = 0
) -> Graph:
    """Zipfian label selectivity: few huge predicates, long tail of rare."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, n_labels + 1)
    zipf /= zipf.sum()
    labels = rng.choice(n_labels, size=n_edges, p=zipf)
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.integers(0, n_nodes, size=n_edges)
    triples = np.stack([src, labels, dst], axis=1)
    g = Graph.from_arrays(n_nodes, n_labels, triples)
    g.node_names = [f"n{i}" for i in range(n_nodes)]
    g.label_names = [f"p{i}" for i in range(n_labels)]
    return g


def random_graph(
    n_nodes: int, n_labels: int, n_edges: int, seed: int = 0
) -> Graph:
    rng = np.random.default_rng(seed)
    triples = np.stack(
        [
            rng.integers(0, n_nodes, size=n_edges),
            rng.integers(0, n_labels, size=n_edges),
            rng.integers(0, n_nodes, size=n_edges),
        ],
        axis=1,
    )
    g = Graph.from_arrays(n_nodes, n_labels, triples)
    g.node_names = [f"n{i}" for i in range(n_nodes)]
    g.label_names = [f"p{i}" for i in range(n_labels)]
    return g


def random_pattern(
    n_vars: int, n_labels: int, n_edges: int, seed: int = 0
) -> Graph:
    """A random connected-ish pattern graph (for graph-graph dual sim)."""
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n_edges):
        if i < n_vars - 1:
            s, o = i, i + 1  # spanning chain keeps it connected
        else:
            s, o = rng.integers(0, n_vars, size=2)
        edges.append((s, rng.integers(0, n_labels), o))
    return Graph.from_arrays(n_vars, n_labels, np.asarray(edges))


# --------------------------------------------------------------------- #
# paper-shaped queries
# --------------------------------------------------------------------- #
def lubm_l0_like() -> Query:
    """Cyclic low-selectivity triangle (the paper's L0 regime: >30 sweeps)."""
    return bgp_of_triples(
        ("?x", "memberOf", "?y"),
        ("?y", "subOrganizationOf", "?z"),
        ("?x", "undergraduateDegreeFrom", "?z"),
    )


def lubm_l1_like() -> Query:
    """The paper's L1: publication with two authors, one student member of a
    department of the university the student got their degree from."""
    return bgp_of_triples(
        ("?pub", "publicationAuthor", "?student"),
        ("?pub", "publicationAuthor", "?prof"),
        ("?student", "memberOf", "?dept"),
        ("?prof", "worksFor", "?dept"),
        ("?dept", "subOrganizationOf", "?univ"),
        ("?student", "undergraduateDegreeFrom", "?univ"),
    )


def optional_query() -> Query:
    """An OPTIONAL-heavy query in the style of Atre's benchmark set."""
    core = bgp_of_triples(("?s", "memberOf", "?d"), ("?d", "subOrganizationOf", "?u"))
    opt1 = bgp_of_triples(("?s", "advisor", "?a"))
    opt2 = bgp_of_triples(("?p", "publicationAuthor", "?s"))
    return Optional_(Optional_(core, opt1), opt2)
