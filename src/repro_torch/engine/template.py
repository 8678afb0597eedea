"""Query templates: constants abstracted into binding slots (DESIGN.md 5.1).

A *template* is a union-free query with every variable renamed to ``v0, v1,
...`` (first-occurrence order) and every constant replaced by a slot marker
``$slot0, $slot1, ...`` (also first-occurrence order; repeated occurrences of
the same constant map to the same slot, preserving the equality the query
expresses).  Two queries that differ only in variable names and constant
values therefore canonicalize to the *same* template key and share one
compiled plan — "same shape, different constants" is a cache hit.

The per-request remainder is a :class:`TemplateInstance`: the slot → constant
assignment plus the canonical-variable → original-name map used to label
results on the way out.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import sparql
from repro_torch.core.sparql import BGP, Const, Query, Triple, Var

SLOT_PREFIX = "$slot"


@dataclasses.dataclass(frozen=True)
class QueryTemplate:
    """A canonical union-free query shape; ``key`` is the plan-cache key."""

    key: str
    query: Query  # canonical AST: Var("v{j}"), Const("$slot{k}")
    n_slots: int
    n_vars: int

    def __hash__(self) -> int:  # Query holds tuples of frozen dataclasses
        return hash(self.key)


@dataclasses.dataclass(frozen=True)
class TemplateInstance:
    """One request: a template plus its constant bindings."""

    template: QueryTemplate
    constants: tuple[str, ...]  # slot k -> constant name
    var_names: tuple[str, ...]  # canonical var j ("v{j}") -> original name

    def rename_bindings(self, rows: dict) -> dict:
        """Map canonical-variable result rows back to the query's names."""
        out = {}
        for name, row in rows.items():
            if name.startswith("v") and name[1:].isdigit():
                j = int(name[1:])
                if j < len(self.var_names):
                    out[self.var_names[j]] = row
                    continue
            out[name] = row
        return out


def slot_index(name: str) -> int | None:
    """Slot number of a ``$slot{k}`` constant name, else None."""
    if name.startswith(SLOT_PREFIX) and name[len(SLOT_PREFIX):].isdigit():
        return int(name[len(SLOT_PREFIX):])
    return None


def canonicalize(q: Query) -> TemplateInstance:
    """Abstract a union-free query into (template, constants, var names)."""
    if not sparql.is_union_free(q):
        raise ValueError("run sparql.union_split first; templates are union-free")
    vmap: dict[str, str] = {}
    cmap: dict[str, str] = {}

    def term(t):
        if isinstance(t, Var):
            if t.name not in vmap:
                vmap[t.name] = f"v{len(vmap)}"
            return Var(vmap[t.name])
        if t.name not in cmap:
            cmap[t.name] = f"{SLOT_PREFIX}{len(cmap)}"
        return Const(cmap[t.name])

    def walk(qq: Query) -> Query:
        if isinstance(qq, BGP):
            return BGP(tuple(Triple(term(t.s), t.p, term(t.o)) for t in qq.triples))
        return type(qq)(walk(qq.left), walk(qq.right))

    cq = walk(q)
    tmpl = QueryTemplate(
        key=template_key(cq), query=cq, n_slots=len(cmap), n_vars=len(vmap)
    )
    # invert the first-occurrence maps back to positional tuples
    var_names = tuple(sorted(vmap, key=lambda orig: int(vmap[orig][1:])))
    constants = tuple(
        sorted(cmap, key=lambda orig: int(cmap[orig][len(SLOT_PREFIX):]))
    )
    return TemplateInstance(template=tmpl, constants=constants, var_names=var_names)


def template_key(q: Query) -> str:
    """Deterministic serialization of a canonical AST (labels included —
    different predicates need different adjacency operands, hence plans)."""
    if isinstance(q, BGP):
        trs = " . ".join(f"{t.s!r} {t.p} {t.o!r}" for t in q.triples)
        return "{" + trs + "}"
    op = type(q).__name__.rstrip("_").upper()
    return f"({template_key(q.left)} {op} {template_key(q.right)})"
