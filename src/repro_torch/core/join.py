"""In-framework SPARQL evaluator (hash joins) — the downstream "database
system" stand-in for the paper's Tables 4/5 experiments, and the match
oracle for the soundness property tests (Theorems 1/2).

Evaluates the paper's fragment S (+UNION) under the standard semantics of
Pérez et al.: BGP via selectivity-ordered hash joins, AND via compatible
inner join, OPTIONAL via compatible left-outer join, UNION via concatenation.
Unbound variables are the sentinel ``-1`` and are compatible with anything.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Graph
from .sparql import And, BGP, Const, Optional_, Query, Triple, Union_, Var


@dataclasses.dataclass
class Bindings:
    """A match table: column per variable, -1 = unbound."""

    cols: dict[str, np.ndarray]  # each (n_rows,) int64

    @property
    def n_rows(self) -> int:
        if not self.cols:
            return 1  # the empty mapping (one trivial match)
        return len(next(iter(self.cols.values())))

    @staticmethod
    def empty_match() -> "Bindings":
        return Bindings(cols={})

    @staticmethod
    def no_match(names: list[str]) -> "Bindings":
        return Bindings(cols={n: np.zeros(0, dtype=np.int64) for n in names})

    def dedup(self) -> "Bindings":
        if not self.cols:
            return self
        names = sorted(self.cols)
        stacked = np.stack([self.cols[n] for n in names], axis=1)
        uniq = np.unique(stacked, axis=0)
        return Bindings(cols={n: uniq[:, i] for i, n in enumerate(names)})


def evaluate(q: Query, g: Graph, *, join_order: str = "selectivity") -> Bindings:
    """``join_order``: 'selectivity' (RDFox-style, smallest table first) or
    'syntactic' (Virtuoso-default-like left-to-right) — the two downstream
    query-plan policies benchmarked in Tables 4/5."""
    return _eval(q, g, join_order).dedup()


def _eval(q: Query, g: Graph, jo: str = "selectivity") -> Bindings:
    if isinstance(q, BGP):
        return _eval_bgp(q, g, jo)
    if isinstance(q, And):
        return _join(_eval(q.left, g, jo), _eval(q.right, g, jo), outer=False)
    if isinstance(q, Optional_):
        return _join(_eval(q.left, g, jo), _eval(q.right, g, jo), outer=True)
    if isinstance(q, Union_):
        return _union(_eval(q.left, g, jo), _eval(q.right, g, jo))
    raise TypeError(q)


# --------------------------------------------------------------------- #
# BGP: selectivity-ordered joins over per-label edge lists
# --------------------------------------------------------------------- #
def _triple_table(t: Triple, g: Graph) -> Bindings:
    if g.label_names is not None and isinstance(t.p, str):
        la = g.label_index().get(t.p, -1)
    else:
        la = int(t.p) if int(t.p) < g.n_labels else -1
    if la < 0:
        names = [x.name for x in (t.s, t.o) if isinstance(x, Var)]
        return Bindings.no_match(names)
    e = g.edges_for_label(la).astype(np.int64)
    s, o = e[:, 0], e[:, 1]
    if isinstance(t.s, Const):
        sid = g.node_id(t.s.name) if g.node_names and t.s.name in g.node_names else -2
        keep = s == sid
        s, o = s[keep], o[keep]
    if isinstance(t.o, Const):
        oid = g.node_id(t.o.name) if g.node_names and t.o.name in g.node_names else -2
        keep = o == oid
        s, o = s[keep], o[keep]
    cols: dict[str, np.ndarray] = {}
    if isinstance(t.s, Var):
        cols[t.s.name] = s
    if isinstance(t.o, Var):
        if isinstance(t.s, Var) and t.o.name == t.s.name:
            keep = s == o
            cols[t.s.name] = s[keep]
        else:
            cols[t.o.name] = o
    if isinstance(t.s, Var) and isinstance(t.o, Var) and t.s.name == t.o.name:
        pass  # handled above
    elif not cols:
        # fully constant pattern: zero or one trivial match
        return Bindings.empty_match() if len(s) else Bindings.no_match([])
    return Bindings(cols=cols)


def _eval_bgp(q: BGP, g: Graph, jo: str = "selectivity") -> Bindings:
    if not q.triples:
        return Bindings.empty_match()
    tables = [_triple_table(t, g) for t in q.triples]
    if jo == "selectivity":
        order = np.argsort([t.n_rows for t in tables])
    else:
        order = np.arange(len(tables))
    acc = tables[order[0]]
    for i in order[1:]:
        acc = _join(acc, tables[i], outer=False)
    return acc


# --------------------------------------------------------------------- #
# compatible joins (NULL-aware)
# --------------------------------------------------------------------- #
def _join(t1: Bindings, t2: Bindings, *, outer: bool) -> Bindings:
    shared = sorted(set(t1.cols) & set(t2.cols))
    only1 = sorted(set(t1.cols) - set(t2.cols))
    only2 = sorted(set(t2.cols) - set(t1.cols))
    n1, n2 = t1.n_rows, t2.n_rows

    if not t2.cols:
        return t1 if t2.n_rows else (t1 if outer else Bindings.no_match(list(t1.cols)))
    if not t1.cols:
        if t1.n_rows == 0:
            return Bindings.no_match(sorted(set(t2.cols)))
        return t2 if (t2.n_rows or not outer) else t2

    nulls1 = any((t1.cols[c] == -1).any() for c in shared)
    nulls2 = any((t2.cols[c] == -1).any() for c in shared)

    if shared and not nulls1 and not nulls2:
        i1, i2 = _hash_join_indices(
            [t1.cols[c] for c in shared], [t2.cols[c] for c in shared]
        )
    elif shared:
        i1, i2 = _compat_join_indices(t1, t2, shared)
    else:
        i1 = np.repeat(np.arange(n1, dtype=np.int64), n2)
        i2 = np.tile(np.arange(n2, dtype=np.int64), n1)

    cols: dict[str, np.ndarray] = {}
    for c in only1:
        cols[c] = t1.cols[c][i1]
    for c in only2:
        cols[c] = t2.cols[c][i2]
    for c in shared:
        a, b = t1.cols[c][i1], t2.cols[c][i2]
        cols[c] = np.where(a == -1, b, a)

    if outer:
        matched = np.zeros(n1, dtype=bool)
        matched[i1] = True
        miss = np.flatnonzero(~matched)
        for c in list(cols):
            extra = (
                t1.cols[c][miss]
                if c in t1.cols
                else np.full(len(miss), -1, dtype=np.int64)
            )
            cols[c] = np.concatenate([cols[c], extra])
    return Bindings(cols=cols)


def _hash_join_indices(keys1: list[np.ndarray], keys2: list[np.ndarray]):
    k1 = np.stack(keys1, axis=1)
    k2 = np.stack(keys2, axis=1)
    both = np.concatenate([k1, k2], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    h1, h2 = inv[: len(k1)], inv[len(k1) :]
    order2 = np.argsort(h2, kind="stable")
    h2s = h2[order2]
    starts = np.searchsorted(h2s, h1, side="left")
    ends = np.searchsorted(h2s, h1, side="right")
    counts = ends - starts
    i1 = np.repeat(np.arange(len(k1), dtype=np.int64), counts)
    offs = np.concatenate([np.arange(c) for c in counts]) if len(counts) else np.zeros(0, np.int64)
    i2 = order2[np.repeat(starts, counts) + offs.astype(np.int64)] if len(i1) else np.zeros(0, np.int64)
    return i1, i2.astype(np.int64)


def _compat_join_indices(t1: Bindings, t2: Bindings, shared: list[str]):
    """NULL-compatible join: blockwise nested loop (rare path: only after
    OPTIONAL/UNION introduced unbound values in join columns)."""
    n1, n2 = t1.n_rows, t2.n_rows
    i1s, i2s = [], []
    a = np.stack([t1.cols[c] for c in shared], axis=1)  # [n1, k]
    b = np.stack([t2.cols[c] for c in shared], axis=1)  # [n2, k]
    block = max(1, int(2_000_000 // max(n2, 1)))
    for s in range(0, n1, block):
        ab = a[s : s + block][:, None, :]  # [b, 1, k]
        ok = ((ab == b[None]) | (ab == -1) | (b[None] == -1)).all(axis=2)
        ii, jj = np.nonzero(ok)
        i1s.append(ii + s)
        i2s.append(jj)
    return (
        np.concatenate(i1s) if i1s else np.zeros(0, np.int64),
        np.concatenate(i2s) if i2s else np.zeros(0, np.int64),
    )


def _union(t1: Bindings, t2: Bindings) -> Bindings:
    names = sorted(set(t1.cols) | set(t2.cols))
    cols = {}
    for c in names:
        a = t1.cols.get(c, np.full(t1.n_rows if t1.cols else 0, -1, np.int64))
        b = t2.cols.get(c, np.full(t2.n_rows if t2.cols else 0, -1, np.int64))
        cols[c] = np.concatenate([a, b])
    return Bindings(cols=cols)


# --------------------------------------------------------------------- #
# required triples (Table 3 column)
# --------------------------------------------------------------------- #
def required_triples(q: Query, g: Graph, matches: Bindings) -> int:
    """Number of distinct database triples participating in some match."""
    used: set[tuple[int, int, int]] = set()

    def walk(qq: Query):
        if isinstance(qq, BGP):
            for t in qq.triples:
                if g.label_names is not None and isinstance(t.p, str):
                    la = g.label_index().get(t.p)
                    if la is None:
                        continue
                else:
                    la = int(t.p)
                sv = (
                    matches.cols.get(t.s.name)
                    if isinstance(t.s, Var)
                    else None
                )
                ov = (
                    matches.cols.get(t.o.name)
                    if isinstance(t.o, Var)
                    else None
                )
                n = matches.n_rows if matches.cols else 0
                if sv is None:
                    sid = g.node_id(t.s.name) if isinstance(t.s, Const) and g.node_names and t.s.name in g.node_names else -2
                    sv = np.full(n, sid, dtype=np.int64)
                if ov is None:
                    oid = g.node_id(t.o.name) if isinstance(t.o, Const) and g.node_names and t.o.name in g.node_names else -2
                    ov = np.full(n, oid, dtype=np.int64)
                ok = (sv >= 0) & (ov >= 0)
                for s, o in zip(sv[ok], ov[ok]):
                    used.add((int(s), la, int(o)))
        else:
            walk(qq.left)
            walk(qq.right)

    walk(q)
    if not used:
        return 0
    # count only triples that actually exist in the DB
    trip = {(int(s), int(p), int(o)) for s, p, o in g.triples}
    return len(used & trip)
