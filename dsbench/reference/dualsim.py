"""Dual simulation of a query over a triple array, in plain NumPy.

Follows Mennicke et al., "Fast Dual Simulation Processing of Graph Database
Queries" (ICDE 2019): the system of inequalities (SOI) of Sect. 3.2 and 4
(one variable per query variable and per constant of a basic graph pattern;
for every pattern edge ``(v, a, w)`` the inequalities ``w <= v x F_a`` and
``v <= w x B_a``; OPTIONAL by Lemma 4 and the syntactically closest rule of
Sect. 4.4, AND by Lemmas 3 and 5), its greatest solution found by
iterating every inequality until nothing changes, and the pruning of
Sect. 5: a triple ``(s, a, o)`` survives iff some pattern edge
``(v, a, w)`` has ``s`` in ``chi(v)`` and ``o`` in ``chi(w)``.

The query text is the paper's language S as the program accepts it:
``{ ?x p c . ?x q ?y }`` groups joined by ``AND`` and ``OPTIONAL``.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np

_TOKEN = re.compile(
    r"\s*(?:(?P<lbrace>\{)|(?P<rbrace>\})|(?P<dot>\.)"
    r"|(?P<kw>(?:AND|OPTIONAL|UNION)\b)"
    r"|(?P<var>\?[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<name>[A-Za-z0-9_:/#\-\.]+))"
)


def parse(text: str):
    """Parse into nested tuples: ``("bgp", [(s, p, o), ...])`` with terms
    ``("var", name)`` / ``("const", name)``, ``("and", l, r)``,
    ``("opt", l, r)``."""
    toks = []
    pos, end = 0, len(text.rstrip())
    while pos < end:
        m = _TOKEN.match(text, pos)
        if not m:
            raise SyntaxError(f"bad token at {text[pos:pos + 30]!r}")
        pos = m.end()
        toks.append((m.lastgroup, m.group(m.lastgroup)))

    def group():
        kind, _ = toks.pop(0)
        if kind != "lbrace":
            raise SyntaxError("expected '{'")
        if toks[0][0] == "lbrace":
            q = expr()
        else:
            triples = []
            while toks[0][0] != "rbrace":
                s, (pk, p), o = term(), toks.pop(0), term()
                if pk != "name":
                    raise SyntaxError(f"expected a predicate, got {p!r}")
                triples.append((s, p, o))
                if toks[0][0] == "dot":
                    toks.pop(0)
            q = ("bgp", triples)
        if toks.pop(0)[0] != "rbrace":
            raise SyntaxError("expected '}'")
        return q

    def term():
        kind, val = toks.pop(0)
        if kind == "var":
            return ("var", val[1:])
        if kind == "name":
            return ("const", val)
        raise SyntaxError(f"expected a term, got {val!r}")

    def expr():
        q = group()
        while toks and toks[0][0] == "kw":
            op = toks.pop(0)[1]
            if op == "UNION":
                raise SyntaxError("UNION is not part of the benchmark's mixes")
            q = ("and" if op == "AND" else "opt", q, group())
        return q

    q = expr()
    if toks:
        raise SyntaxError(f"trailing tokens {toks[:3]}")
    return q


@dataclasses.dataclass
class System:
    """An SOI: variables, pattern edges and copy inequalities."""

    names: list[str]  # variable -> query variable or constant name
    const: list[bool]  # variable -> is a constant
    edges: list[tuple[int, str, int]]  # pattern edges (v, label, w)
    copies: list[tuple[int, int]]  # lhs <= rhs

    @property
    def n_vars(self) -> int:
        return len(self.names)

    def operators(self) -> list[str]:
        """Labels of the pattern edges, each once: every label gives a
        forward and a backward operator."""
        return list(dict.fromkeys(a for _, a, _ in self.edges))

    def var_ids(self) -> dict[str, list[int]]:
        """Query variable -> every SOI variable standing for it."""
        out: dict[str, list[int]] = {}
        for i, (n, c) in enumerate(zip(self.names, self.const)):
            if not c:
                out.setdefault(n, []).append(i)
        return out


def build(q) -> System:
    """The SOI of a parsed query (paper Sect. 3.2 and 4)."""
    names, const, edges, copies = [], [], [], []
    parent: list[int] = []

    def new(name, is_const):
        names.append(name)
        const.append(is_const)
        parent.append(len(parent))
        return len(names) - 1

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def rec(q):
        """Returns (mandatory: name -> var, optional: name -> [vars])."""
        if q[0] == "bgp":
            ids = {}
            for s, p, o in q[1]:
                for t in (s, o):
                    if t not in ids:
                        ids[t] = new(t[1], t[0] == "const")
                edges.append((ids[s], p, ids[o]))
            return {t[1]: v for t, v in ids.items() if t[0] == "var"}, {}
        m1, o1 = rec(q[1])
        m2, o2 = rec(q[2])
        mand, opt = {}, {}
        for n in set(m1) | set(o1) | set(m2) | set(o2):
            ma, mb = m1.get(n), m2.get(n)
            oa, ob = list(o1.get(n, [])), list(o2.get(n, []))
            if q[0] == "opt":
                occ2 = ([mb] if mb is not None else []) + ob
                if ma is not None:  # Lemma 4: v_Q2 <= v
                    copies.extend((i, ma) for i in occ2)
                    mand[n] = ma
                    if oa:
                        opt[n] = oa
                elif oa + occ2:  # optional in both: independent
                    opt[n] = oa + occ2
            elif ma is not None and mb is not None:  # Lemma 3: one variable
                parent[find(mb)] = find(ma)
                mand[n] = ma
            elif ma is not None:  # Lemma 5: opt <= mand
                copies.extend((i, ma) for i in ob)
                mand[n] = ma
            elif mb is not None:
                copies.extend((i, mb) for i in oa)
                mand[n] = mb
            elif oa + ob:
                opt[n] = oa + ob
        return mand, opt

    rec(q)
    roots = sorted({find(i) for i in range(len(names))})
    new_id = {r: j for j, r in enumerate(roots)}
    f = lambda i: new_id[find(i)]
    return System(
        names=[names[r] for r in roots],
        const=[const[r] for r in roots],
        edges=[(f(v), a, f(w)) for v, a, w in edges],
        copies=sorted({(f(l), f(r)) for l, r in copies if f(l) != f(r)}),
    )


class Data:
    """The triples both sides are given, indexed by label once."""

    def __init__(self, triples: np.ndarray, n_nodes: int,
                 node_index: dict[str, int], label_index: dict[str, int]):
        self.triples = triples
        self.n_nodes = n_nodes
        self.node_index = node_index
        self.label_index = label_index
        lab = triples[:, 1]
        self._order = np.argsort(lab, kind="stable")
        counts = np.bincount(lab, minlength=len(label_index))
        self._start = np.concatenate([[0], np.cumsum(counts)])

    def rows(self, label: str) -> np.ndarray:
        """Row numbers of the triples with this label (empty if absent)."""
        a = self.label_index.get(label)
        if a is None:
            return np.zeros(0, np.int64)
        return self._order[self._start[a]:self._start[a + 1]]

    def edge_count(self, label: str) -> int:
        a = self.label_index.get(label)
        return 0 if a is None else int(self._start[a + 1] - self._start[a])


def _init(sys_: System, data: Data) -> np.ndarray:
    chi = np.ones((sys_.n_vars, data.n_nodes), dtype=bool)
    for i, (name, c) in enumerate(zip(sys_.names, sys_.const)):
        if c:
            chi[i] = False
            nid = data.node_index.get(name)
            if nid is not None:
                chi[i, nid] = True
    return chi


def _apply(sys_: System, data: Data, chi: np.ndarray, read: np.ndarray) -> None:
    """Apply every inequality once, reading ``read`` and shrinking ``chi``
    (the same array for a sweep that reads its own updates)."""
    n = data.n_nodes
    for v, a, w in sys_.edges:
        r = data.rows(a)
        s, o = data.triples[r, 0], data.triples[r, 2]
        y = np.zeros(n, dtype=bool)
        y[o[read[v][s]]] = True  # w <= v x F_a
        chi[w] &= y
        y = np.zeros(n, dtype=bool)
        y[s[read[w][o]]] = True  # v <= w x B_a
        chi[v] &= y
    for lhs, rhs in sys_.copies:
        chi[lhs] &= read[rhs]


def solve(sys_: System, data: Data, max_sweeps: int | None = None) -> np.ndarray:
    """The greatest solution ``chi [V, n]`` of the SOI; ``max_sweeps``
    stops early (the control's broken guarantee, never the reference)."""
    chi = _init(sys_, data)
    sweeps = 0
    while True:
        before = chi.copy()
        _apply(sys_, data, chi, chi)
        sweeps += 1
        if np.array_equal(before, chi):
            return chi
        if max_sweeps is not None and sweeps >= max_sweeps:
            return chi


def solve_one_pass(sys_: System, data: Data) -> np.ndarray:
    """The control: every inequality applied once to the start values, all
    reading the same start (no fixpoint), which breaks the guarantee that
    answers are the greatest dual simulation."""
    chi = _init(sys_, data)
    _apply(sys_, data, chi, chi.copy())
    return chi


def prune(sys_: System, data: Data, chi: np.ndarray) -> np.ndarray:
    """Survivor mask over ``data.triples`` (paper Sect. 5)."""
    mask = np.zeros(len(data.triples), dtype=bool)
    for v, a, w in sys_.edges:
        r = data.rows(a)
        hit = chi[v][data.triples[r, 0]] & chi[w][data.triples[r, 2]]
        mask[r[hit]] = True
    return mask


def bindings(sys_: System, chi: np.ndarray) -> dict[str, np.ndarray]:
    """Per query variable, the union of its SOI variables' candidates."""
    return {n: np.logical_or.reduce(chi[ids], axis=0)
            for n, ids in sys_.var_ids().items()}


def answer(text: str, data: Data, *, control: bool = False):
    """``(survivor mask, bindings)`` of one query; ``control`` takes the
    one-pass control in the fixpoint's place."""
    sys_ = build(parse(text))
    chi = solve_one_pass(sys_, data) if control else solve(sys_, data)
    return prune(sys_, data, chi), bindings(sys_, chi)
