"""LUBM data after the UBA generator's published profile, vectorised.

Guo, Pan and Heflin, "LUBM: A benchmark for OWL knowledge base systems",
J. Web Semantics 3(2), 2005: per university 15-25 departments; per
department 7-10 full, 10-14 associate and 8-11 assistant professors and
5-7 lecturers, one full professor heading it; 8-14 undergraduates and 3-4
graduate students per faculty member; 10-20 research groups; 1-2 courses
and 1-2 graduate courses per faculty member; 15-20, 10-18, 5-10 and 0-5
publications per full, associate, assistant professor and lecturer;
undergraduates take 2-4 courses and graduate students 1-3 graduate
courses; every graduate student and a fifth of undergraduates have an
advisor; 1/5-1/4 of graduate students assist teaching and 1/4-1/3 research.
Degrees come from a uniform university of UBA's fixed universe of 1000
(its ``UNIV_NUM``), of which only the generated ones carry a type; the
others are bare nodes named as UBA names them.  Every range comes from the configuration file; draws are uniform inside
each range (inclusive).  Every count (departments, people, courses,
publications, course loads, advisors, assistants) is drawn from the
configuration's fixed ``size_seed``, so every run holds the same number of
entities and edges of each kind; the seed of the run draws the wiring: which
course, advisor, university or publication each edge goes to.
"""
from __future__ import annotations

import numpy as np

from . import Corpus, dedupe

FACULTY = ("FullProfessor", "AssociateProfessor", "AssistantProfessor", "Lecturer")
CONFIG_KEYS = ("full_professors", "associate_professors", "assistant_professors",
               "lecturers")
CLASSES = ("University", "Department", "ResearchGroup", *FACULTY, "Course",
           "GraduateCourse", "UndergraduateStudent", "GraduateStudent",
           "ResearchAssistant", "Publication")
LABELS = ("type", "name", "emailAddress", "telephone", "researchInterest",
          "subOrganizationOf", "worksFor", "headOf", "memberOf",
          "undergraduateDegreeFrom", "mastersDegreeFrom", "doctoralDegreeFrom",
          "teacherOf", "takesCourse", "advisor", "teachingAssistantOf",
          "publicationAuthor", "imports")


def _draw(rng, lo_hi, size):
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, size=size)


def _pick(rng, group, start, length):
    """For each item of ``group``, a uniform id in its group's
    ``[start, start + length)``."""
    return start[group] + (rng.random(len(group)) * length[group]).astype(np.int64)


def _per(counts):
    """Owner index of each of ``sum(counts)`` items, and its rank there."""
    owner = np.repeat(np.arange(len(counts)), counts)
    first = np.cumsum(counts) - counts
    return owner, np.arange(len(owner)) - first[owner]


def generate(cfg: dict, rng: np.random.Generator) -> Corpus:
    size = np.random.default_rng(cfg["size_seed"])
    n_u = cfg["universities"]
    n_d_u = _draw(size, cfg["departments_per_university"], n_u)
    dept_u, dept_k = _per(n_d_u)
    n_d = len(dept_u)

    # faculty, ordered by department then kind
    fac_counts = np.stack([_draw(size, cfg[k], n_d) for k in CONFIG_KEYS], axis=1)
    n_fac_d = fac_counts.sum(1)
    owner, fac_k = _per(fac_counts.ravel())
    fac_d, fac_kind = owner // len(FACULTY), owner % len(FACULTY)
    n_fac = len(fac_d)
    lo, hi = cfg["undergraduates_per_faculty"]
    n_ug_d = size.integers(lo * n_fac_d, hi * n_fac_d + 1)
    lo, hi = cfg["graduates_per_faculty"]
    n_gs_d = size.integers(lo * n_fac_d, hi * n_fac_d + 1)
    n_rg_d = _draw(size, cfg["research_groups"], n_d)
    c1 = _draw(size, cfg["courses_per_faculty"], n_fac)
    c2 = _draw(size, cfg["graduate_courses_per_faculty"], n_fac)
    pub_ranges = np.array([cfg["publications"][k] for k in FACULTY])
    n_pub_f = size.integers(pub_ranges[fac_kind, 0], pub_ranges[fac_kind, 1] + 1)

    # ids: classes, the ontology, then entities kind by kind, then literals
    names: list[str] = list(CLASSES) + ["UnivBenchOntology"]
    cls = {c: i for i, c in enumerate(CLASSES)}
    ontology = len(names) - 1

    def block(n, make):
        base = len(names)
        names.extend(make())
        assert len(names) == base + n
        return base + np.arange(n, dtype=np.int64)

    n_univ = cfg["degree_universities"]
    univ = block(n_univ, lambda: [f"University{u}" for u in range(n_univ)])
    uni = univ[:n_u]
    du, dk = dept_u.tolist(), dept_k.tolist()
    dept = block(n_d, lambda: [f"U{u}_D{d}" for u, d in zip(du, dk)])
    dfile = block(n_d, lambda: [f"U{u}_D{d}_File" for u, d in zip(du, dk)])

    def per_dept(counts, label):
        owner, rank = _per(counts)
        ou, od, rk = dept_u[owner].tolist(), dept_k[owner].tolist(), rank.tolist()
        ids = block(len(owner), lambda: [f"U{u}_D{d}_{label}{k}"
                                         for u, d, k in zip(ou, od, rk)])
        start = np.cumsum(counts) - counts
        return ids, owner, ids[0] + start if len(ids) else start, counts

    rg, rg_d, _, _ = per_dept(n_rg_d, "ResearchGroup")
    fu, fd = dept_u[fac_d].tolist(), dept_k[fac_d].tolist()
    fk, fkind = fac_k.tolist(), fac_kind.tolist()
    fac = block(n_fac, lambda: [f"U{u}_D{d}_{FACULTY[c]}{k}"
                                for u, d, c, k in zip(fu, fd, fkind, fk)])
    crs, crs_d, crs_start, crs_n = per_dept(np.bincount(fac_d, c1, n_d).astype(int), "Course")
    gcr, gcr_d, gcr_start, gcr_n = per_dept(np.bincount(fac_d, c2, n_d).astype(int), "GraduateCourse")
    ug, ug_d, _, _ = per_dept(n_ug_d, "UndergraduateStudent")
    gs, gs_d, _, _ = per_dept(n_gs_d, "GraduateStudent")
    pub_d_counts = np.bincount(fac_d, n_pub_f, n_d).astype(int)
    pub, pub_d, pub_start, pub_n = per_dept(pub_d_counts, "Publication")

    out = []

    def emit(label, s, o):
        s = np.asarray(s, np.int64)
        o = np.broadcast_to(np.asarray(o, np.int64), s.shape)
        out.append(np.stack([s, np.full(len(s), LABELS.index(label)), o], 1))

    # types
    emit("type", uni, cls["University"])
    emit("type", dept, cls["Department"])
    emit("type", rg, cls["ResearchGroup"])
    emit("type", fac, np.array([cls[c] for c in FACULTY])[fac_kind])
    emit("type", crs, cls["Course"])
    emit("type", gcr, cls["GraduateCourse"])
    emit("type", ug, cls["UndergraduateStudent"])
    emit("type", gs, cls["GraduateStudent"])
    emit("type", pub, cls["Publication"])
    emit("imports", dfile, ontology)
    # organisation
    emit("subOrganizationOf", dept, uni[dept_u])
    emit("subOrganizationOf", rg, dept[rg_d])
    emit("worksFor", fac, dept[fac_d])
    first_fp = np.cumsum(n_fac_d) - n_fac_d  # the first faculty member is a full professor
    emit("headOf", fac[first_fp], dept)
    emit("memberOf", ug, dept[ug_d])
    emit("memberOf", gs, dept[gs_d])
    # degrees from a uniform university of UBA's universe, generated or not
    for label in ("undergraduateDegreeFrom", "mastersDegreeFrom", "doctoralDegreeFrom"):
        emit(label, fac, univ[rng.integers(0, n_univ, n_fac)])
    emit("undergraduateDegreeFrom", gs, univ[rng.integers(0, n_univ, len(gs))])
    # teaching: each course has one teacher, the faculty member it came from
    emit("teacherOf", np.repeat(fac, c1), crs)
    emit("teacherOf", np.repeat(fac, c2), gcr)
    # course loads, inside the student's department
    k = _draw(size, cfg["undergraduate_courses_taken"], len(ug))
    emit("takesCourse", np.repeat(ug, k), _pick(rng, np.repeat(ug_d, k), crs_start, crs_n))
    k = _draw(size, cfg["graduate_courses_taken"], len(gs))
    emit("takesCourse", np.repeat(gs, k), _pick(rng, np.repeat(gs_d, k), gcr_start, gcr_n))
    # advisors: a professor (not a lecturer) of the department
    prof_d = np.bincount(fac_d, fac_kind < 3, n_d).astype(int)
    prof = fac[fac_kind < 3]
    prof_start = np.cumsum(prof_d) - prof_d
    adv = size.random(len(ug)) < cfg["undergraduate_advisor_share"]
    emit("advisor", ug[adv], prof[_pick(rng, ug_d[adv], prof_start, prof_d)])
    emit("advisor", gs, prof[_pick(rng, gs_d, prof_start, prof_d)])
    # assistants: a per-department share of its graduate students
    u = size.random(len(gs))
    ta_share = size.uniform(*cfg["teaching_assistant_share"], n_d)[gs_d]
    ta = u < ta_share
    emit("teachingAssistantOf", gs[ta], _pick(rng, gs_d[ta], crs_start, crs_n))
    ra = (u >= ta_share) & (u < ta_share + size.uniform(*cfg["research_assistant_share"], n_d)[gs_d])
    emit("type", gs[ra], cls["ResearchAssistant"])
    # publications: the faculty author, and graduate co-authors of the department
    emit("publicationAuthor", pub, np.repeat(fac, n_pub_f))
    k = _draw(size, cfg["graduate_coauthored_publications"], len(gs))
    ok = pub_n[np.repeat(gs_d, k)] > 0
    emit("publicationAuthor", _pick(rng, np.repeat(gs_d, k)[ok], pub_start, pub_n), np.repeat(gs, k)[ok])
    # literals: one distinct node per value
    people = np.concatenate([fac, ug, gs])
    named = np.concatenate([uni, dept, people, crs, gcr, pub])
    for label, subj in (("name", named), ("emailAddress", people),
                        ("telephone", people), ("researchInterest", fac[fac_kind < 3])):
        lit = block(len(subj), lambda n=len(subj), b=len(names): [f"L{i}" for i in range(b, b + n)])
        emit(label, subj, lit)

    triples = dedupe(np.concatenate(out), len(names), len(LABELS)).astype(np.int32)
    pools = {c: ids for c, ids in (
        ("University", uni), ("Department", dept), ("ResearchGroup", rg),
        ("Course", crs), ("GraduateCourse", gcr), ("UndergraduateStudent", ug),
        ("GraduateStudent", gs), ("Publication", pub))}
    for c, kind in zip(FACULTY, range(4)):
        pools[c] = fac[fac_kind == kind]
    pools["Faculty"] = fac
    counts = {"universities": n_u, "departments": n_d, "faculty": n_fac,
              "undergraduates": len(ug), "graduates": len(gs),
              "courses": len(crs) + len(gcr), "publications": len(pub),
              "triples": len(triples), "nodes": len(names), "labels": len(LABELS)}
    return Corpus(triples=triples, node_names=names, label_names=list(LABELS),
                  pools=pools, counts=counts)
