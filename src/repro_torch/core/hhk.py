"""HHK-style simulation algorithm (Henzinger, Henzinger, Kopke 1995),
adapted to edge-labeled graphs and to *dual* simulation, per the paper's
Sect. 3.3 complexity discussion ("specific data complexity hypothesis").

The classic algorithm maintains, per pattern node v (and here per incident
label/direction), a *remove set*: data nodes that have an a-edge but whose
a-neighbours no longer intersect sim(v).  Processing a nonempty remove set
shrinks the simulators of v's pattern neighbours.  We run the machinery on
forward and backward edges simultaneously, which is what "executing HHK two
times" amounts to for dual simulation.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def dual_simulation_hhk(pattern: Graph, db: Graph) -> tuple[np.ndarray, int]:
    """Largest dual simulation via labeled-HHK remove sets.

    Returns (S bool[|V1|, |V2|], number of remove-set pops).
    """
    n1, n2 = pattern.n_nodes, db.n_nodes
    labels = sorted(set(int(a) for a in pattern.triples[:, 1]))

    # dense boolean adjacency per (label, dir) — fine at reference scale
    F = {a: db.dense_adjacency(a) for a in labels}
    B = {a: db.dense_adjacency(a, backward=True) for a in labels}
    has_f = {a: F[a].any(axis=1) for a in labels}  # x has a-successor
    has_b = {a: B[a].any(axis=1) for a in labels}  # x has a-predecessor

    sim = np.ones((n1, n2), dtype=bool)
    p_out = [[] for _ in range(n1)]
    p_in = [[] for _ in range(n1)]
    for s, a, o in pattern.triples:
        p_out[s].append((int(a), int(o)))
        p_in[o].append((int(a), int(s)))

    # init: Eq.-13-equivalent sharpening (HHK's "prefilter")
    for v in range(n1):
        for a, _ in p_out[v]:
            sim[v] &= has_f[a]
        for a, _ in p_in[v]:
            sim[v] &= has_b[a]

    # remove_fwd[(v, a)] = {x : x has a-succ but none in sim(v)}
    def mk_remove_f(v, a):
        reach = F[a] @ sim[v]  # x -> count of a-successors in sim(v)
        return has_f[a] & ~(reach > 0)

    def mk_remove_b(v, a):
        reach = B[a] @ sim[v]
        return has_b[a] & ~(reach > 0)

    rem_f = {}
    rem_b = {}
    for v in range(n1):
        for a in {a for a, _ in p_out[v]} | {a for a, _ in p_in[v]}:
            rem_f[(v, a)] = mk_remove_f(v, a)
            rem_b[(v, a)] = mk_remove_b(v, a)

    pops = 0
    dirty = True
    while dirty:
        dirty = False
        for key in list(rem_f):
            v, a = key
            r = rem_f[key]
            if not r.any():
                continue
            pops += 1
            rem_f[key] = np.zeros(n2, dtype=bool)
            # u --a--> v in pattern: simulators of u must reach sim(v)
            for aa, u in p_in[v]:
                if aa != a:
                    continue
                newu = sim[u] & ~r
                if not np.array_equal(newu, sim[u]):
                    sim[u] = newu
                    _refresh(u, sim, p_out, p_in, rem_f, rem_b, mk_remove_f, mk_remove_b)
                    dirty = True
        for key in list(rem_b):
            v, a = key
            r = rem_b[key]
            if not r.any():
                continue
            pops += 1
            rem_b[key] = np.zeros(n2, dtype=bool)
            # v --a--> w in pattern: simulators of w must be reached from sim(v)
            for aa, w in p_out[v]:
                if aa != a:
                    continue
                neww = sim[w] & ~r
                if not np.array_equal(neww, sim[w]):
                    sim[w] = neww
                    _refresh(w, sim, p_out, p_in, rem_f, rem_b, mk_remove_f, mk_remove_b)
                    dirty = True
    return sim, pops


def _refresh(v, sim, p_out, p_in, rem_f, rem_b, mk_f, mk_b):
    """Recompute remove sets of a shrunk pattern node (simplified HHK: the
    original maintains them incrementally; recomputation keeps the same
    fixpoint and pass structure at higher constant cost)."""
    for a in {a for a, _ in p_out[v]} | {a for a, _ in p_in[v]}:
        rem_f[(v, a)] = mk_f(v, a)
        rem_b[(v, a)] = mk_b(v, a)
