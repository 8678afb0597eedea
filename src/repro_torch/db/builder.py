"""Fluent query builder for the paper's fragment S (DESIGN.md 6.3).

Programmatic callers used to string-format query text and re-parse it; the
builder constructs :mod:`repro_torch.core.sparql` ASTs directly, with the same
grammar the paper gives (Sect. 4)::

    Q ::= BGP | Q AND Q | Q OPTIONAL Q | Q UNION Q

Usage — terms starting with ``?`` are variables, everything else constants::

    q = (Q.triple("?d", "memberOf", "?u")
          .triple("?s", "advisor", "?d")          # extends the same BGP
          .and_(Q.triple("?u", "subOrganizationOf", "Univ0"))
          .optional("{ ?s publicationAuthor ?p }")  # text mixes in fine
          .union(("?s", "headOf", "?d")))           # so do bare triples
    q.build()    # -> core.sparql Query AST
    q.sparql()   # -> text that parse() round-trips to an equal AST

Builders are immutable: every call returns a new ``Q``, so prefixes can be
shared and specialized.  ``sparql()`` goes through
:func:`repro_torch.core.sparql.format_query`, whose output is guaranteed to
``parse`` back to the identical AST (the builder only accepts predicate /
constant names in the parser's token class, keeping that guarantee tight).
"""
from __future__ import annotations

import re
from typing import Callable

from repro_torch.core import sparql
from repro_torch.core.sparql import (
    BGP,
    And,
    Const,
    Optional_,
    Query,
    Term,
    Triple,
    Union_,
    Var,
    format_query,
)

# the parser's `name` / `var` token classes: accepting only these keeps
# builder -> format_query -> parse a guaranteed identity
_NAME = re.compile(r"[A-Za-z0-9_:/#\-\.]+\Z")
_VAR = re.compile(r"\?[A-Za-z_][A-Za-z0-9_]*\Z")
# names the tokenizer would lex as a keyword instead of a name (its kw
# alternative wins at a word boundary, e.g. "AND", "WHERE", "AND:x")
_KEYWORD = re.compile(r"(?:AND|OPTIONAL|UNION|SELECT|WHERE)\b")


def _valid_name(x: str) -> bool:
    return bool(_NAME.match(x)) and not _KEYWORD.match(x)


def _term(x: str | Term) -> Term:
    if isinstance(x, (Var, Const)):
        return x
    if not isinstance(x, str):
        raise TypeError(f"term must be str or Var/Const, got {type(x).__name__}")
    if x.startswith("?"):
        if not _VAR.match(x):
            raise ValueError(f"invalid variable name {x!r}")
        return Var(x[1:])
    if not _valid_name(x):
        raise ValueError(f"invalid constant name {x!r} (not a parser token)")
    return Const(x)


def _label(p: str) -> str:
    if not isinstance(p, str) or not _valid_name(p):
        raise ValueError(f"invalid predicate label {p!r} (not a parser token)")
    return p


class _StartOrChain:
    """Descriptor so ``Q.triple(...)`` starts a builder and
    ``q.triple(...)`` extends one — the class itself is the empty builder."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.__doc__ = fn.__doc__

    def __get__(self, obj, cls):
        target = obj if obj is not None else cls()
        return lambda *args, **kwargs: self.fn(target, *args, **kwargs)


class Q:
    """Immutable fluent builder over the Sect.-4 query algebra."""

    __slots__ = ("_q",)

    def __init__(self, query: Query | None = None):
        self._q = query

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def _triple(self, s: str | Term, p: str, o: str | Term) -> "Q":
        """Start a BGP (``Q.triple(...)``) or append to one (``q.triple(...)``).

        Appending to a composite (AND/OPTIONAL/UNION root) is ambiguous —
        use ``.and_(...)`` there instead.
        """
        t = Triple(_term(s), _label(p), _term(o))
        if self._q is None:
            return Q(BGP((t,)))
        if isinstance(self._q, BGP):
            return Q(BGP(self._q.triples + (t,)))
        raise TypeError(
            "cannot .triple() onto a composite query; wrap the new pattern "
            "in .and_(Q.triple(...)) / .optional(...) / .union(...)"
        )

    triple = _StartOrChain(_triple)

    @classmethod
    def bgp(cls, *spo: tuple[str, str, str]) -> "Q":
        """Build a whole BGP at once from (s, p, o) string triples."""
        q = cls()
        for s, p, o in spo:
            q = q.triple(s, p, o)
        return q

    @classmethod
    def parse(cls, text: str) -> "Q":
        """Wrap parsed query text in a builder."""
        return cls(sparql.parse(text))

    # ------------------------------------------------------------------ #
    # the three binary operators
    # ------------------------------------------------------------------ #
    def and_(self, other) -> "Q":
        """``self AND other`` (Pérez et al. algebra; paper Sect. 4)."""
        return Q(And(self.build(), _coerce(other)))

    def optional(self, other) -> "Q":
        """``self OPTIONAL other``."""
        return Q(Optional_(self.build(), _coerce(other)))

    def union(self, other) -> "Q":
        """``self UNION other`` (split away before SOI construction)."""
        return Q(Union_(self.build(), _coerce(other)))

    # ------------------------------------------------------------------ #
    # output
    # ------------------------------------------------------------------ #
    def build(self) -> Query:
        """The finished :mod:`repro_torch.core.sparql` AST."""
        if self._q is None:
            raise ValueError("empty builder: add at least one triple")
        return self._q

    def sparql(self) -> str:
        """Query text; ``parse(q.sparql()) == q.build()`` always holds."""
        return format_query(self.build())

    def __eq__(self, other) -> bool:
        return isinstance(other, Q) and self._q == other._q

    def __hash__(self) -> int:
        return hash(self._q)

    def __repr__(self) -> str:
        return f"Q({self.sparql()})" if self._q is not None else "Q(<empty>)"


def _coerce(other) -> Query:
    """Accept a Q, an AST, query text, or a bare (s, p, o) triple."""
    if isinstance(other, Q):
        return other.build()
    if isinstance(other, (BGP, And, Optional_, Union_)):
        return other
    if isinstance(other, str):
        return sparql.parse(other)
    if (
        isinstance(other, tuple)
        and len(other) == 3
        and all(isinstance(x, (str, Var, Const)) for x in other)
    ):
        s, p, o = other
        return BGP((Triple(_term(s), _label(p), _term(o)),))
    raise TypeError(
        f"cannot build a query operand from {type(other).__name__}: "
        "pass a Q, a parsed Query, query text, or an (s, p, o) triple"
    )
