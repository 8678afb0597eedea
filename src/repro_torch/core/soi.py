"""System-of-inequalities (SOI) construction — paper Sect. 3.2 + Sect. 4.

For every pattern edge ``(v, a, w)`` the SOI contains (Eq. 11)::

    w  <=  v ×b F_a        (forward inequality)
    v  <=  w ×b B_a        (backward inequality)

plus per-variable initialization (Eq. 12 / sharper Eq. 13 summaries) and, for
OPTIONAL / non-well-designed AND combinations, plain copy inequalities
``v_opt <= v_mand`` (Eq. 14/15, Lemmas 4/5) produced by the optional-renaming
machinery with the paper's *syntactically closest* rule (Sect. 4.4).

The builder is recursive over the query AST; UNION is split away beforehand
(:func:`repro_torch.core.sparql.union_split`).  Exposure model:

* ``external_mand[name]`` — the unique mandatory representative variable.
* ``external_opt[name]``  — optional occurrence variables not yet linked to a
  mandatory occurrence.  When a mandatory occurrence appears at an enclosing
  operator, each of these receives ``opt <= mand`` and stops being exposed,
  which reproduces the paper's chains ``z_R3 <= z_R2 <= z``.
* constants get private singleton variables per BGP — never merged, so an
  unsatisfied optional branch can never empty a mandatory constant.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import sparql
from .graph import Graph
from .sparql import And, BGP, Const, Optional_, Query, Var

FWD, BWD = 0, 1


@dataclasses.dataclass
class SOI:
    """A built (but not yet graph-compiled) system of inequalities."""

    base: list[str]  # internal var id -> original query variable name
    is_const: list[str | None]  # internal var id -> constant name or None
    edge_ineqs: list[tuple[int, int, str, int]]  # (lhs, rhs, label, dir)
    copy_ineqs: list[tuple[int, int]]  # lhs <= rhs
    pattern_edges: list[tuple[int, str, int]]  # (v, label, w) — for pruning
    external_mand: dict[str, int]
    external_opt: dict[str, list[int]]

    @property
    def n_vars(self) -> int:
        return len(self.base)

    def var_groups(self) -> dict[str, list[int]]:
        """Original variable name -> every internal id carrying it."""
        groups: dict[str, list[int]] = {}
        for i, b in enumerate(self.base):
            if self.is_const[i] is None:
                groups.setdefault(b, []).append(i)
        return groups


# --------------------------------------------------------------------- #
# recursive construction
# --------------------------------------------------------------------- #
def build_soi(q: Query) -> SOI:
    if not sparql.is_union_free(q):
        raise ValueError("run sparql.union_split first; build_soi is union-free")
    return _build(q)


def _build(q: Query) -> SOI:
    if isinstance(q, BGP):
        return _build_bgp(q)
    if isinstance(q, And):
        return _combine(_build(q.left), _build(q.right), optional=False)
    if isinstance(q, Optional_):
        return _combine(_build(q.left), _build(q.right), optional=True)
    raise TypeError(q)


def _build_bgp(q: BGP) -> SOI:
    base: list[str] = []
    is_const: list[str | None] = []
    ids: dict[str, int] = {}

    def vid(term) -> int:
        key = f"?{term.name}" if isinstance(term, Var) else f"<{term.name}>"
        if key not in ids:
            ids[key] = len(base)
            base.append(term.name)
            is_const.append(term.name if isinstance(term, Const) else None)
        return ids[key]

    edge_ineqs, pattern_edges = [], []
    for t in q.triples:
        v, w = vid(t.s), vid(t.o)
        pattern_edges.append((v, t.p, w))
        edge_ineqs.append((w, v, t.p, FWD))  # w <= v ×b F_a
        edge_ineqs.append((v, w, t.p, BWD))  # v <= w ×b B_a
    mand = {
        t.name
        for tr in q.triples
        for t in (tr.s, tr.o)
        if isinstance(t, Var)
    }
    return SOI(
        base=base,
        is_const=is_const,
        edge_ineqs=edge_ineqs,
        copy_ineqs=[],
        pattern_edges=pattern_edges,
        external_mand={n: ids[f"?{n}"] for n in mand},
        external_opt={},
    )


def _combine(e1: SOI, e2: SOI, *, optional: bool) -> SOI:
    """AND (Lemmas 3/5) or OPTIONAL (Lemma 4 + Sect. 4.4) combination."""
    off = e1.n_vars
    base = e1.base + e2.base
    is_const = e1.is_const + e2.is_const
    edge_ineqs = e1.edge_ineqs + [
        (l + off, r + off, a, d) for (l, r, a, d) in e2.edge_ineqs
    ]
    copy_ineqs = e1.copy_ineqs + [(l + off, r + off) for (l, r) in e2.copy_ineqs]
    pattern_edges = e1.pattern_edges + [
        (v + off, a, w + off) for (v, a, w) in e2.pattern_edges
    ]
    m2 = {n: i + off for n, i in e2.external_mand.items()}
    o2 = {n: [i + off for i in ids] for n, ids in e2.external_opt.items()}

    mand_out: dict[str, int] = {}
    opt_out: dict[str, list[int]] = {}
    merges: list[tuple[int, int]] = []  # (keep, drop)

    names = (
        set(e1.external_mand) | set(e1.external_opt) | set(m2) | set(o2)
    )
    for n in names:
        ma, mb = e1.external_mand.get(n), m2.get(n)
        oa = list(e1.external_opt.get(n, []))
        ob = list(o2.get(n, []))
        if optional:
            # OPTIONAL(q1, q2): result mandatory = mand(q1).  Any occurrence
            # of n in q2 (mandatory-in-q2 or unlinked-optional) is optional
            # w.r.t. the result.
            occ2 = ([mb] if mb is not None else []) + ob
            if ma is not None:
                # Lemma 4: rename q2's occurrence(s), add  v_Q2 <= v.
                copy_ineqs.extend((i, ma) for i in occ2)
                mand_out[n] = ma
                if oa:
                    opt_out[n] = oa
            else:
                # optional-in-both (Sect. 4.4): independent, no links.
                occ = oa + occ2
                if occ:
                    opt_out[n] = occ
        else:
            # AND(q1, q2), Lemmas 3/5.
            if ma is not None and mb is not None:
                merges.append((ma, mb))  # shared mandatory: identical variable
                mand_out[n] = ma
            elif ma is not None:
                copy_ineqs.extend((i, ma) for i in ob)  # rho_2: opt <= mand
                mand_out[n] = ma
            elif mb is not None:
                copy_ineqs.extend((i, mb) for i in oa)  # rho_1
                mand_out[n] = mb
            else:
                occ = oa + ob
                if occ:
                    opt_out[n] = occ

    soi = SOI(
        base=base,
        is_const=is_const,
        edge_ineqs=edge_ineqs,
        copy_ineqs=copy_ineqs,
        pattern_edges=pattern_edges,
        external_mand=mand_out,
        external_opt=opt_out,
    )
    # Apply merges sequentially, translating each pair through the id
    # compaction of the previous merges (stale ids would otherwise merge
    # the WRONG variables — e.g. a surrogate instead of its mandatory
    # original; caught by the Thm.-2 soundness property test).
    trans = {i: i for i in range(soi.n_vars)}
    for keep, drop in merges:
        k, d = trans[keep], trans[drop]
        if k == d:
            continue
        soi, remap = _merge_vars(soi, k, d)
        trans = {o: remap[c] for o, c in trans.items()}
    return soi


def _merge_vars(soi: SOI, keep: int, drop: int) -> tuple[SOI, dict]:
    """Identify variable ``drop`` with ``keep`` and compact ids.
    Returns (new_soi, remap old-id -> new-id)."""
    remap = {}
    j = 0
    for i in range(soi.n_vars):
        if i == drop:
            continue
        remap[i] = j
        j += 1
    remap[drop] = remap[keep]
    f = lambda i: remap[i]
    base = [b for i, b in enumerate(soi.base) if i != drop]
    is_const = [c for i, c in enumerate(soi.is_const) if i != drop]
    return SOI(
        base=base,
        is_const=is_const,
        edge_ineqs=[(f(l), f(r), a, d) for (l, r, a, d) in soi.edge_ineqs],
        copy_ineqs=sorted({(f(l), f(r)) for (l, r) in soi.copy_ineqs if f(l) != f(r)}),
        pattern_edges=[(f(v), a, f(w)) for (v, a, w) in soi.pattern_edges],
        external_mand={n: f(i) for n, i in soi.external_mand.items()},
        external_opt={n: [f(i) for i in ids] for n, ids in soi.external_opt.items()},
    ), remap


# --------------------------------------------------------------------- #
# compile against a concrete graph database
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class CompiledSOI:
    """SOI lowered to dense index arrays against one graph's label table.

    ``mats`` enumerates the distinct (label_id, direction) adjacency
    operators the SOI needs; ``ineq_mat[i]`` indexes into it.  ``init`` is
    the Eq.-13 initialization (label-summary intersections + constant
    singletons).  Inequalities whose label is absent from the database force
    the LHS variable to the empty set (handled via ``init``).
    """

    soi: SOI
    n_vars: int
    n_nodes: int
    mats: list[tuple[int, int]]  # (label_id, FWD/BWD)
    ineq_lhs: np.ndarray  # (I,) int32
    ineq_rhs: np.ndarray  # (I,) int32
    ineq_mat: np.ndarray  # (I,) int32 -> index into mats
    copy_lhs: np.ndarray  # (C,) int32
    copy_rhs: np.ndarray  # (C,) int32
    init: np.ndarray  # (n_vars, n_nodes) bool


def compile_soi(
    soi: SOI,
    g: Graph,
    node_index: dict[str, int] | None = None,
    label_index: dict[str, int] | None = None,
) -> CompiledSOI:
    """Lower ``soi`` against ``g``.

    ``node_index`` / ``label_index`` map names -> ids; callers that already
    hold them (the engine does) pass them down so constants and labels
    resolve in O(1) instead of an O(n) ``list.index`` scan each.  Falls back
    to the graph's own cached indexes otherwise.
    """
    assert g.label_names is not None or all(
        isinstance(a, int) for (_, _, a, _) in soi.edge_ineqs
    ), "graph must carry label names (or SOI labels must be int ids)"
    if label_index is None and g.label_names is not None:
        label_index = g.label_index()

    def lid(a) -> int | None:
        if isinstance(a, int):
            return a if a < g.n_labels else None
        return label_index.get(a)  # None = label absent from the database

    n = g.n_nodes
    init = np.ones((soi.n_vars, n), dtype=bool)

    # Eq. 13: intersect per-variable with forward/backward summaries.
    dead = np.zeros(soi.n_vars, dtype=bool)
    for v, a, w in soi.pattern_edges:
        la = lid(a)
        if la is None:
            dead[v] = dead[w] = True  # no a-edges at all -> no simulators
            continue
        init[v] &= g.summary_fwd(la)
        init[w] &= g.summary_bwd(la)
    init[dead] = False

    # constants: singleton sets.
    if node_index is None and any(c is not None for c in soi.is_const):
        node_index = g.node_index() if g.node_names is not None else {}
    for i, c in enumerate(soi.is_const):
        if c is None:
            continue
        row = np.zeros(n, dtype=bool)
        nid = node_index.get(c)
        if nid is not None:
            row[nid] = init[i][nid]
        init[i] = row

    mats: list[tuple[int, int]] = []
    mat_index: dict[tuple[int, int], int] = {}
    lhs, rhs, mat = [], [], []
    for l, r, a, d in soi.edge_ineqs:
        la = lid(a)
        if la is None:
            continue  # already zeroed via init
        key = (la, d)
        if key not in mat_index:
            mat_index[key] = len(mats)
            mats.append(key)
        lhs.append(l)
        rhs.append(r)
        mat.append(mat_index[key])

    cl = [l for (l, _) in soi.copy_ineqs]
    cr = [r for (_, r) in soi.copy_ineqs]
    return CompiledSOI(
        soi=soi,
        n_vars=soi.n_vars,
        n_nodes=n,
        mats=mats,
        ineq_lhs=np.asarray(lhs, dtype=np.int32),
        ineq_rhs=np.asarray(rhs, dtype=np.int32),
        ineq_mat=np.asarray(mat, dtype=np.int32),
        copy_lhs=np.asarray(cl, dtype=np.int32),
        copy_rhs=np.asarray(cr, dtype=np.int32),
        init=init,
    )


def collect(soi: SOI, chi: np.ndarray) -> dict[str, np.ndarray]:
    """Per original query variable, the union of all its internal rows.

    Renamed optional surrogates are unified with their originals (paper
    Sect. 4.3/4.4 "interpreted as if all renamed variables are unified").
    """
    out: dict[str, np.ndarray] = {}
    for name, ids in soi.var_groups().items():
        out[name] = np.logical_or.reduce(chi[ids], axis=0)
    return out
