"""The one request generator: it reads a traffic mix file and a corpus.

Two kinds of mix:

* ``templates``: query families with fixed text and constant slots
  ``%0``, ``%1``...; every block of ``sum(count)`` requests holds each
  family ``count`` times in a seeded order, and each slot draws its
  constant uniformly from the named pool of the corpus;
* ``schema_walk``: every request a new template, a random walk of
  ``min_patterns``..``max_patterns`` pattern edges over the
  configuration's schema graph, half of them with one constant drawn
  uniformly from its variable's class.

Both return the window's request sequence (clients take it in order) and
the requests the set-up warms with.
"""
from __future__ import annotations

import dataclasses

import numpy as np

LITERAL = "Literal"  # the schema's class of literal values: walks do not go on from it


@dataclasses.dataclass
class Requests:
    window: list[tuple[str, str]]  # (family, query text), in the order served
    warm: list[tuple[str, str]]  # one request per plan shape to warm
    warm_all_buckets: bool  # warm every microbatch bucket, or bucket 1 only


def generate(mix: dict, cfg: dict, corpus, rng: np.random.Generator) -> Requests:
    if mix["kind"] == "templates":
        return _templates(mix, corpus, rng)
    if mix["kind"] == "schema_walk":
        return _walks(mix, cfg, corpus, rng)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")


def _fill(fam: dict, corpus, rng, n: int) -> list[str]:
    texts = [fam["text"]] * n
    for j, pool in enumerate(fam.get("constants", [])):
        ids = corpus.pool(pool)
        picks = ids[rng.integers(0, len(ids), n)]
        texts = [t.replace(f"%{j}", corpus.node_names[c]) for t, c in zip(texts, picks.tolist())]
    return texts


def _templates(mix: dict, corpus, rng) -> Requests:
    fams = mix["families"]
    block = np.repeat(np.arange(len(fams)), [f["count"] for f in fams])
    n_blocks = -(-mix["requests"] // len(block))
    order = np.concatenate([rng.permutation(block) for _ in range(n_blocks)])
    texts = {i: iter(_fill(f, corpus, rng, int((order == i).sum())))
             for i, f in enumerate(fams)}
    window = [(fams[i]["name"], next(texts[i])) for i in order.tolist()]
    warm = [(f["name"], _fill(f, corpus, rng, 1)[0]) for f in fams]
    return Requests(window=window, warm=warm, warm_all_buckets=True)


def canonical(triples: list[tuple[str, str, str]]) -> str:
    """Variables renamed by first occurrence, constants by slot: two walks
    with the same key share a plan."""
    names: dict[str, str] = {}

    def term(t):
        if t not in names:
            names[t] = (f"v{len(names)}" if t.startswith("?") else f"$c{len(names)}")
        return names[t]

    return " . ".join(f"{term(s)} {p} {term(o)}" for s, p, o in triples)


def _walks(mix: dict, cfg: dict, corpus, rng) -> Requests:
    """Blocks that each hold one walk of every length from ``min_patterns``
    to ``max_patterns``, with and without a constant, so half the requests
    carry one.  A walk whose canonical form was seen before is drawn again.  The walks' shapes and predicates come from the mix's fixed
    ``walk_seed``, so every run serves the same templates block by block;
    the run's seed orders each block and draws the constants."""
    schema = cfg["schema"]
    classes = sorted({d for d, _, _ in schema})
    kinds = [(n, c) for n in range(mix["min_patterns"], mix["max_patterns"] + 1)
             for c in (False, True)]
    seen: set[str] = set()
    out: list[tuple[str, str]] = []
    need = mix["requests"] + mix["warm_requests"]
    shape = np.random.default_rng(mix["walk_seed"])
    while len(out) < need:
        block = []
        for n_pat, with_const in kinds:
            for _ in range(1000):
                walk = _walk(schema, classes, n_pat, with_const, corpus, shape, rng)
                key = canonical(walk)
                if key not in seen:
                    break
            else:
                raise RuntimeError(f"no new walk of {n_pat} patterns in 1000 draws")
            seen.add(key)
            family = f"walk{n_pat}" + ("c" if with_const else "")
            block.append((family, "{ " + " . ".join(" ".join(t) for t in walk) + " }"))
        out += [block[k] for k in rng.permutation(len(block)).tolist()]
    n = mix["requests"]
    return Requests(window=out[:n], warm=out[n:need], warm_all_buckets=False)


def _walk(schema, classes, n_pat, with_const, corpus, shape, rng):
    """A random walk (drawn from ``shape``) of ``n_pat`` pattern edges over
    the schema graph, from a uniform class; a walk stepping onto a literal
    goes on from a uniform earlier variable; with ``with_const`` one uniform
    non-literal variable becomes a constant drawn (from ``rng``) uniformly
    from its class."""
    cls = [classes[shape.integers(len(classes))]]
    triples = []
    while len(triples) < n_pat:
        live = [i for i, c in enumerate(cls) if c != LITERAL]
        cur = len(cls) - 1 if cls[-1] != LITERAL else live[shape.integers(len(live))]
        steps = ([(p, r, True) for d, p, r in schema if d == cls[cur]]
                 + [(p, d, False) for d, p, r in schema if r == cls[cur]])
        p, other, forward = steps[shape.integers(len(steps))]
        cls.append(other)
        new = len(cls) - 1
        triples.append((f"?v{cur}", p, f"?v{new}") if forward else (f"?v{new}", p, f"?v{cur}"))
    if with_const:
        live = [i for i, c in enumerate(cls) if c != LITERAL]
        v = live[shape.integers(len(live))]
        ids = corpus.pool(cls[v])
        name = corpus.node_names[int(ids[rng.integers(len(ids))])]
        triples = [tuple(name if t == f"?v{v}" else t for t in tr) for tr in triples]
    return triples
