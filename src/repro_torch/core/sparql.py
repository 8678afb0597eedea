"""SPARQL query fragment from the paper (Sect. 4): the language S.

    Q ::= BGP | Q AND Q | Q OPTIONAL Q | Q UNION Q

Triple patterns are ``(s, p, o)`` where ``s``/``o`` are :class:`Var` or
:class:`Const` and ``p`` is a predicate label.  ``UNION`` is removed before
SOI construction by the DNF-style rewriting of Pérez et al. (Prop. 3.8 in the
paper); ``mand()`` computes mandatory-variable sets for the optional-renaming
machinery of Sect. 4.3/4.4.

A tiny text parser is provided for queries written like::

    SELECT WHERE {
      { ?director directed ?movie . ?director worked_with ?coworker }
    }

with ``{..} AND {..}``, ``{..} OPTIONAL {..}``, ``{..} UNION {..}`` at any
nesting depth.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Union as TUnion


@dataclasses.dataclass(frozen=True)
class Var:
    name: str

    def __repr__(self) -> str:
        return f"?{self.name}"


@dataclasses.dataclass(frozen=True)
class Const:
    """A database constant (IRI or literal), referenced by name."""

    name: str

    def __repr__(self) -> str:
        return f"<{self.name}>"


Term = TUnion[Var, Const]


@dataclasses.dataclass(frozen=True)
class Triple:
    s: Term
    p: str
    o: Term


@dataclasses.dataclass(frozen=True)
class BGP:
    triples: tuple[Triple, ...]


@dataclasses.dataclass(frozen=True)
class And:
    left: "Query"
    right: "Query"


@dataclasses.dataclass(frozen=True)
class Optional_:
    left: "Query"
    right: "Query"


@dataclasses.dataclass(frozen=True)
class Union_:
    left: "Query"
    right: "Query"


Query = TUnion[BGP, And, Optional_, Union_]


# --------------------------------------------------------------------- #
# variable analysis (paper Sect. 4.3)
# --------------------------------------------------------------------- #
def vars_of(q: Query) -> set[str]:
    if isinstance(q, BGP):
        out: set[str] = set()
        for t in q.triples:
            for term in (t.s, t.o):
                if isinstance(term, Var):
                    out.add(term.name)
        return out
    return vars_of(q.left) | vars_of(q.right)


def mand(q: Query) -> set[str]:
    """Mandatory variables: mand(BGP)=vars, mand(AND)=∪, mand(OPT)=mand(left)."""
    if isinstance(q, BGP):
        return vars_of(q)
    if isinstance(q, And):
        return mand(q.left) | mand(q.right)
    if isinstance(q, Optional_):
        return mand(q.left)
    if isinstance(q, Union_):
        # union-free rewriting happens first; for analysis use intersection
        # (a variable is certainly bound only if bound in every branch).
        return mand(q.left) & mand(q.right)
    raise TypeError(q)


def labels_of(q: Query) -> set[str]:
    if isinstance(q, BGP):
        return {t.p for t in q.triples}
    return labels_of(q.left) | labels_of(q.right)


def is_union_free(q: Query) -> bool:
    if isinstance(q, BGP):
        return True
    if isinstance(q, Union_):
        return False
    return is_union_free(q.left) and is_union_free(q.right)


# --------------------------------------------------------------------- #
# UNION normal form (Prop. 3.8 of Pérez et al., as cited by the paper)
# --------------------------------------------------------------------- #
def union_split(q: Query) -> list[Query]:
    """Rewrite ``q`` into a list of union-free queries whose result union
    equals (for AND/left-OPTIONAL distribution) or over-approximates (for
    UNION nested in the optional side) the original result set.  Soundness of
    the dual-simulation pruning only needs the over-approximation direction,
    see DESIGN.md Sect. 3."""
    if isinstance(q, BGP):
        return [q]
    if isinstance(q, Union_):
        return union_split(q.left) + union_split(q.right)
    lefts = union_split(q.left)
    rights = union_split(q.right)
    ctor = And if isinstance(q, And) else Optional_
    return [ctor(l, r) for l in lefts for r in rights]


# --------------------------------------------------------------------- #
# parser
# --------------------------------------------------------------------- #
_TOKEN = re.compile(
    r"\s*(?:(?P<lbrace>\{)|(?P<rbrace>\})|(?P<dot>\.)"
    r"|(?P<kw>(?:AND|OPTIONAL|UNION|SELECT|WHERE)\b)"  # \b: ANDERSON is a name
    r"|(?P<var>\?[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<name>[A-Za-z0-9_:/#\-\.]+))"
)


def _line_col(text: str, pos: int) -> tuple[int, int]:
    """1-based (line, column) of character offset ``pos`` in ``text``."""
    line = text.count("\n", 0, pos) + 1
    col = pos - (text.rfind("\n", 0, pos) + 1) + 1
    return line, col


def _err(text: str, pos: int, msg: str) -> SyntaxError:
    line, col = _line_col(text, pos)
    return SyntaxError(f"{msg} at line {line}, column {col}")


def parse(text: str) -> Query:
    """Parse the small query language described in the module docstring.

    Malformed input raises :class:`SyntaxError` with the 1-based line and
    column of the offending token; empty groups ``{}`` are rejected (a
    vacuous ``BGP(())`` matches everything, which is never what a typo
    meant).
    """
    toks: list[tuple[str, str, int]] = []  # (kind, value, char offset)
    pos = 0
    end = len(text.rstrip())
    while pos < end:
        m = _TOKEN.match(text, pos)
        if not m:
            at = pos + len(text[pos:]) - len(text[pos:].lstrip())
            raise _err(text, at, f"bad token at {text[at:at+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        val = m.group(kind)
        if kind == "kw" and val in ("SELECT", "WHERE"):
            continue
        toks.append((kind, val, m.start(kind)))

    if not toks:
        raise _err(text, 0, "empty query")

    def peek():
        return toks[0] if toks else (None, None, end)

    def pop(expect=None):
        if not toks:
            raise _err(text, end, "unexpected end of query")
        kind, val, at = toks.pop(0)
        if expect and kind != expect:
            raise _err(text, at, f"expected {expect}, got {kind} {val!r}")
        return kind, val

    def parse_group() -> Query:
        _, _, open_at = toks[0] if toks else (None, None, end)
        pop("lbrace")
        if peek()[0] == "rbrace":
            raise _err(text, open_at, "empty group '{}'")
        if peek()[0] == "lbrace":  # nested composite
            q = parse_expr()
            pop("rbrace")
            return q
        triples = []
        while peek()[0] != "rbrace":
            s = parse_term()
            _, p = pop("name")
            o = parse_term()
            triples.append(Triple(s, p, o))
            if peek()[0] == "dot":
                pop("dot")
        pop("rbrace")
        return BGP(tuple(triples))

    def parse_term() -> Term:
        if not toks:
            raise _err(text, end, "unexpected end of query")
        kind, val, at = toks.pop(0)
        if kind == "var":
            return Var(val[1:])
        if kind == "name":
            return Const(val)
        raise _err(text, at, f"expected term, got {kind} {val!r}")

    def parse_expr() -> Query:
        left = parse_group()
        while peek()[0] == "kw":
            _, op = pop("kw")
            right = parse_group()
            left = {"AND": And, "OPTIONAL": Optional_, "UNION": Union_}[op](
                left, right
            )
        return left

    q = parse_expr()
    if toks:
        raise _err(text, toks[0][2], f"trailing tokens: {toks[0][1]!r}")
    return q


# --------------------------------------------------------------------- #
# pretty-printer (inverse of parse)
# --------------------------------------------------------------------- #
def format_term(t: Term) -> str:
    return f"?{t.name}" if isinstance(t, Var) else t.name


def format_query(q: Query) -> str:
    """Serialize a query so that ``parse(format_query(q)) == q``.

    The guarantee holds for ASTs whose constant / predicate names match the
    parser's ``name`` token class (``[A-Za-z0-9_:/#.-]+``) and whose BGPs are
    non-empty — i.e. everything the parser or the :mod:`repro_torch.db.builder`
    can produce.
    """
    if isinstance(q, BGP):
        if not q.triples:
            raise ValueError("cannot format an empty BGP (parse rejects {})")
        body = " . ".join(
            f"{format_term(t.s)} {t.p} {format_term(t.o)}" for t in q.triples
        )
        return "{ " + body + " }"
    op = {And: "AND", Optional_: "OPTIONAL", Union_: "UNION"}[type(q)]
    return "{ " + f"{format_query(q.left)} {op} {format_query(q.right)}" + " }"


def bgp_of_triples(*spo: tuple[str, str, str]) -> BGP:
    """Convenience: strings starting with '?' are variables, else constants."""

    def term(x: str) -> Term:
        return Var(x[1:]) if x.startswith("?") else Const(x)

    return BGP(tuple(Triple(term(s), p, term(o)) for s, p, o in spo))
