"""N-Triples-style RDF reader/writer with dictionary encoding.

Two ingest paths:

* :func:`load` — convenience wrapper over ``Graph.from_triples``; builds a
  Python list of string tuples first, fine for test fixtures.
* :func:`load_stream` — chunked streaming ingest for the DBpedia/LUBM-scale
  workload (DESIGN.md 12.5): triples are dictionary-encoded straight into int32
  chunk buffers as lines are read, so peak memory is the name dictionaries
  plus one ``(chunk_triples, 3) int32`` buffer — never a tuple-per-triple
  Python list (~25x smaller transient footprint at 10^6+ edges).

:func:`dump_stream` is the writing mirror: serialize an *iterator* of
string triples without materializing a Graph.
"""
from __future__ import annotations

import re
from typing import Iterable, Iterator

import numpy as np

from repro_torch.core.graph import Graph

_LINE = re.compile(
    r"^\s*(<[^>]+>|\S+)\s+(<[^>]+>|\S+)\s+(<[^>]+>|\"[^\"]*\"\S*|\S+)\s*\.?\s*$"
)


def _strip(term: str) -> str:
    if term.startswith("<") and term.endswith(">"):
        return term[1:-1]
    return term


def iter_triples(lines: Iterable[str]) -> Iterator[tuple[str, str, str]]:
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"bad triple line: {line[:80]!r}")
        yield _strip(m.group(1)), _strip(m.group(2)), _strip(m.group(3))


def load(path: str) -> Graph:
    with open(path) as f:
        return Graph.from_triples(iter_triples(f))


def load_stream(path: str, chunk_triples: int = 1 << 20) -> Graph:
    """Streaming dictionary-encoding ingest of an N-Triples file.

    Equivalent to :func:`load` (same ids: first-seen order), but encodes
    each parsed line directly into an int32 chunk buffer instead of
    accumulating Python tuples, so arbitrarily large files ingest with
    O(dictionary + chunk) transient memory.
    """
    if chunk_triples < 1:
        raise ValueError("chunk_triples must be >= 1")
    nodes: dict[str, int] = {}
    labels: dict[str, int] = {}
    chunks: list[np.ndarray] = []
    buf = np.empty((chunk_triples, 3), np.int32)
    k = 0
    with open(path) as f:
        for s, p, o in iter_triples(f):
            buf[k, 0] = nodes.setdefault(s, len(nodes))
            buf[k, 1] = labels.setdefault(p, len(labels))
            buf[k, 2] = nodes.setdefault(o, len(nodes))
            k += 1
            if k == chunk_triples:
                chunks.append(buf)
                buf = np.empty((chunk_triples, 3), np.int32)
                k = 0
    chunks.append(buf[:k])
    arr = np.concatenate(chunks) if len(chunks) > 1 else chunks[0].copy()
    return Graph(
        n_nodes=len(nodes),
        n_labels=len(labels),
        triples=arr,
        node_names=list(nodes),
        label_names=list(labels),
    )


def dump(g: Graph, path: str) -> None:
    assert g.node_names is not None and g.label_names is not None
    with open(path, "w") as f:
        for s, p, o in g.triples:
            f.write(
                f"<{g.node_names[s]}> <{g.label_names[p]}> <{g.node_names[o]}> .\n"
            )


def dump_stream(
    triples: Iterable[tuple[str, str, str]], path: str
) -> int:
    """Write an iterator of string triples as N-Triples; returns the count.

    The workload generator side of :func:`load_stream`: neither end ever
    holds the full triple set as Python objects.
    """
    count = 0
    with open(path, "w") as f:
        for s, p, o in triples:
            f.write(f"<{s}> <{p}> <{o}> .\n")
            count += 1
    return count
