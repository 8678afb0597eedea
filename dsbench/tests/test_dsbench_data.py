"""The corpus generators: seeded, inside the published profiles."""
import json

import numpy as np

from dsbench.data import uba
from dsbench.harness import BENCH


def _config(name, **over):
    with open(BENCH / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def test_same_seed_same_triples():
    cfg = _config("lubm-30", universities=2)
    a = uba.generate(cfg, np.random.default_rng(11))
    b = uba.generate(cfg, np.random.default_rng(11))
    c = uba.generate(cfg, np.random.default_rng(12))
    assert np.array_equal(a.triples, b.triples)
    assert a.node_names == b.node_names and a.label_names == b.label_names
    assert not np.array_equal(a.triples, c.triples)


def test_uba_counts_inside_the_profile():
    cfg = _config("lubm-30", universities=3)
    c = uba.generate(cfg, np.random.default_rng(3))
    names, t = c.node_names, c.triples
    lab = {n: i for i, n in enumerate(c.label_names)}
    assert sorted(lab) == sorted(uba.LABELS) and len(lab) == 18
    assert set(np.unique(t[:, 1]).tolist()) == set(range(18))  # every predicate used
    cls = {n: i for i, n in enumerate(names[:len(uba.CLASSES)])}
    typed = {k: t[(t[:, 1] == lab["type"]) & (t[:, 2] == cls[k]), 0] for k in uba.CLASSES}
    dept_of = dict(t[t[:, 1] == lab["subOrganizationOf"]][:, [0, 2]].tolist())
    for u in typed["University"].tolist():
        n_d = sum(1 for d in typed["Department"].tolist() if dept_of[d] == u)
        assert 15 <= n_d <= 25
    works = t[t[:, 1] == lab["worksFor"]]
    member = t[t[:, 1] == lab["memberOf"]]
    for d in typed["Department"].tolist():
        staff = set(works[works[:, 2] == d, 0].tolist())
        n_fac = len(staff)
        for kind, key in zip(uba.FACULTY, uba.CONFIG_KEYS):
            lo, hi = cfg[key]
            assert lo <= len(staff & set(typed[kind].tolist())) <= hi
        students = set(member[member[:, 2] == d, 0].tolist())
        n_ug = len(students & set(typed["UndergraduateStudent"].tolist()))
        n_gs = len(students & set(typed["GraduateStudent"].tolist()))
        assert 8 * n_fac <= n_ug <= 14 * n_fac
        assert 3 * n_fac <= n_gs <= 4 * n_fac
    # every graduate student has one advisor; a fifth of undergraduates one
    adv = t[t[:, 1] == lab["advisor"], 0]
    assert set(typed["GraduateStudent"].tolist()) <= set(adv.tolist())
    share = len(set(adv.tolist()) & set(typed["UndergraduateStudent"].tolist())) / len(typed["UndergraduateStudent"])
    assert 0.15 < share < 0.25
    # one head per department, a full professor
    heads = t[t[:, 1] == lab["headOf"]]
    assert len(heads) == len(typed["Department"])
    assert set(heads[:, 0].tolist()) <= set(typed["FullProfessor"].tolist())


def test_uba_sizes_do_not_depend_on_the_seed():
    cfg = _config("lubm-30", universities=2)
    a = uba.generate(cfg, np.random.default_rng(1))
    b = uba.generate(cfg, np.random.default_rng(2))
    assert a.node_names == b.node_names
    # only repeated picks, dropped as duplicates, may differ
    assert abs(len(a.triples) - len(b.triples)) <= 0.002 * len(a.triples)


def test_uba_degrees_come_from_the_whole_universe():
    cfg = _config("lubm-30", universities=3)
    c = uba.generate(cfg, np.random.default_rng(5))
    lab = {n: i for i, n in enumerate(c.label_names)}
    t = c.triples
    degree = t[np.isin(t[:, 1], [lab[k] for k in ("undergraduateDegreeFrom", "mastersDegreeFrom",
                                                 "doctoralDegreeFrom")]), 2]
    univ = {n: i for i, n in enumerate(c.node_names) if n[10:].isdigit() and n[:10] == "University"}
    assert len(univ) == cfg["degree_universities"] == 1000
    typed = set(t[(t[:, 1] == lab["type"]) & (t[:, 2] == c.node_names.index("University")), 0].tolist())
    assert typed == {univ[f"University{u}"] for u in range(3)}
    # about 3 in 1000 degrees are from a generated (typed) university
    share = np.isin(degree, list(typed)).mean()
    assert set(degree.tolist()) <= set(univ.values()) and 0.0 < share < 0.02
