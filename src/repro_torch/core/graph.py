"""Edge-labeled directed graphs and graph databases (paper Sect. 2).

A graph is ``G = (V, Sigma, E)`` with ``E ⊆ V × Sigma × V``.  Nodes and labels
are dictionary-encoded to dense ints.  Four physical layouts coexist:

* **triples** — ``(E, 3) int32`` array of (src, label, dst); canonical form.
* **per-label CSR** — forward map F_a / backward map B_a (paper's adjacency
  maps) as index arrays; used by the numpy reference engines and the join
  evaluator.
* **triple positions** — the positions of the triples by subject, by object
  and by label (:class:`TripleIndex`); used by pruning.
* **dense boolean / bit-packed adjacency** — per-label ``bool[n, n]`` or
  ``uint32[n, n/32]`` matrices; used by the MXU / Pallas engines (viable up to
  ~64k nodes per shard; the sparse edge-list engine covers DB scale).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterable

import numpy as np

from . import bitops

# Hard budget on any [n, n] plane: past this, a dense adjacency (or the
# transient dense build inside packed_adjacency) cannot be materialized at
# all — construction raises MemoryError instead of OOMing the host, and
# engine.cost refuses the dense-layout engine tier before it gets here
# (the RDF workload runs where this is structurally impossible).
DENSE_ADJ_MAX_BYTES = 2 << 30

# Builds every snapshot's triple index once: replicas sharing a snapshot may
# reach their first prune together.
_TRIPLE_INDEX_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class TripleIndex:
    """The positions of a snapshot's triples in three orders, each stably
    sorted, with CSR pointers: the triples of subject ``u`` are
    ``triples[pos_s[ptr_s[u]:ptr_s[u + 1]]]``, those of object ``u`` the same
    through ``ptr_o`` / ``pos_o``, and those of label ``a`` through ``ptr_l``
    / ``pos_l``.  Positions are int32 and pointers int64."""

    ptr_s: np.ndarray  # [n_nodes + 1]
    pos_s: np.ndarray  # [E]
    ptr_o: np.ndarray  # [n_nodes + 1]
    pos_o: np.ndarray  # [E]
    ptr_l: np.ndarray  # [n_labels + 1]
    pos_l: np.ndarray  # [E]

    @staticmethod
    def build(g: "Graph") -> "TripleIndex":
        ptr_s, pos_s = _positions(g.triples[:, 0], g.n_nodes)
        ptr_o, pos_o = _positions(g.triples[:, 2], g.n_nodes)
        ptr_l, pos_l = _positions(g.triples[:, 1], g.n_labels)
        return TripleIndex(ptr_s, pos_s, ptr_o, pos_o, ptr_l, pos_l)


def _positions(keys: np.ndarray, size: int) -> tuple[np.ndarray, np.ndarray]:
    """``(ptr, pos)``: the positions of ``keys`` stably sorted by key, and
    where each key's run starts, for keys in ``[0, size)``."""
    pos = np.argsort(keys, kind="stable").astype(np.int32)
    ptr = np.zeros(size + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys, minlength=size), out=ptr[1:])
    return ptr, pos


@dataclasses.dataclass
class Graph:
    """An edge-labeled directed graph over dense int ids."""

    n_nodes: int
    n_labels: int
    triples: np.ndarray  # (E, 3) int32: (src, label, dst)
    node_names: list[str] | None = None
    label_names: list[str] | None = None

    # lazily built indexes
    _fwd_csr: dict | None = dataclasses.field(default=None, repr=False)
    _bwd_csr: dict | None = dataclasses.field(default=None, repr=False)
    _node_index: dict | None = dataclasses.field(default=None, repr=False)
    _label_index: dict | None = dataclasses.field(default=None, repr=False)
    _triple_index: TripleIndex | None = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_triples(
        triples: Iterable[tuple[str, str, str]],
    ) -> "Graph":
        """Build from (subject, predicate, object) string triples."""
        nodes: dict[str, int] = {}
        labels: dict[str, int] = {}
        enc = []
        for s, p, o in triples:
            si = nodes.setdefault(s, len(nodes))
            pi = labels.setdefault(p, len(labels))
            oi = nodes.setdefault(o, len(nodes))
            enc.append((si, pi, oi))
        arr = np.asarray(enc, dtype=np.int32).reshape(-1, 3)
        return Graph(
            n_nodes=len(nodes),
            n_labels=len(labels),
            triples=arr,
            node_names=list(nodes),
            label_names=list(labels),
        )

    @staticmethod
    def from_arrays(n_nodes: int, n_labels: int, triples: np.ndarray) -> "Graph":
        triples = np.asarray(triples, dtype=np.int32).reshape(-1, 3)
        if len(triples):
            assert triples[:, [0, 2]].max() < n_nodes, "node id out of range"
            assert triples[:, 1].max() < n_labels, "label id out of range"
        return Graph(n_nodes=n_nodes, n_labels=n_labels, triples=triples)

    # ------------------------------------------------------------------ #
    # id helpers
    # ------------------------------------------------------------------ #
    def node_index(self) -> dict[str, int]:
        """Cached name -> id map over ``node_names`` (snapshots are
        immutable, so building it once per graph is safe)."""
        if self._node_index is None:
            assert self.node_names is not None
            self._node_index = {n: i for i, n in enumerate(self.node_names)}
        return self._node_index

    def label_index(self) -> dict[str, int]:
        """Cached name -> id map over ``label_names``."""
        if self._label_index is None:
            assert self.label_names is not None
            self._label_index = {n: i for i, n in enumerate(self.label_names)}
        return self._label_index

    def triple_index(self) -> TripleIndex:
        """The snapshot's :class:`TripleIndex`, built at first use, once
        however many threads ask together."""
        if self._triple_index is None:
            with _TRIPLE_INDEX_LOCK:
                if self._triple_index is None:
                    self._triple_index = TripleIndex.build(self)
        return self._triple_index

    def node_id(self, name: str) -> int:
        return self.node_index()[name]

    def label_id(self, name: str) -> int:
        return self.label_index()[name]

    @property
    def n_edges(self) -> int:
        return int(self.triples.shape[0])

    # ------------------------------------------------------------------ #
    # per-label edge lists (sparse engine / segment message passing)
    # ------------------------------------------------------------------ #
    def edges_for_label(self, a: int) -> np.ndarray:
        """(Ea, 2) int32 (src, dst) rows with label ``a``."""
        m = self.triples[:, 1] == a
        return self.triples[m][:, [0, 2]]

    def label_histogram(self) -> np.ndarray:
        return np.bincount(self.triples[:, 1], minlength=self.n_labels)

    # ------------------------------------------------------------------ #
    # CSR adjacency maps (paper's F^a / B^a) — numpy reference engines
    # ------------------------------------------------------------------ #
    def fwd(self, a: int, v: int) -> np.ndarray:
        """F^a(v): successor set of v via a-labeled edges."""
        self._build_csr()
        ptr, idx = self._fwd_csr[a]
        return idx[ptr[v] : ptr[v + 1]]

    def bwd(self, a: int, v: int) -> np.ndarray:
        """B^a(v): predecessor set of v via a-labeled edges."""
        self._build_csr()
        ptr, idx = self._bwd_csr[a]
        return idx[ptr[v] : ptr[v + 1]]

    def _build_csr(self) -> None:
        if self._fwd_csr is not None:
            return
        self._fwd_csr, self._bwd_csr = {}, {}
        for a in range(self.n_labels):
            e = self.edges_for_label(a)
            self._fwd_csr[a] = _csr(e[:, 0], e[:, 1], self.n_nodes)
            self._bwd_csr[a] = _csr(e[:, 1], e[:, 0], self.n_nodes)

    # ------------------------------------------------------------------ #
    # dense / packed adjacency (MXU + Pallas engines)
    # ------------------------------------------------------------------ #
    def dense_adjacency(self, a: int, backward: bool = False) -> np.ndarray:
        """bool[n, n] forward (or backward) adjacency matrix for label a.

        Raises ``MemoryError`` when the [n, n] plane would exceed
        ``DENSE_ADJ_MAX_BYTES`` — at RDF scale the dense tier does not
        exist, and failing here (cheaply, before allocation) is what the
        ``--rdf`` bench asserts.
        """
        if self.n_nodes * self.n_nodes > DENSE_ADJ_MAX_BYTES:
            raise MemoryError(
                f"dense [n, n] adjacency at n={self.n_nodes} needs "
                f"{self.n_nodes * self.n_nodes} bytes > budget "
                f"{DENSE_ADJ_MAX_BYTES}; use the edge-list engines"
            )
        e = self.edges_for_label(a)
        m = np.zeros((self.n_nodes, self.n_nodes), dtype=bool)
        if backward:
            m[e[:, 1], e[:, 0]] = True
        else:
            m[e[:, 0], e[:, 1]] = True
        return m

    def packed_adjacency(self, a: int, backward: bool = False) -> np.ndarray:
        """uint32[n, ceil(n/32)] bit-packed adjacency for label a.

        Equal to ``pack_np(dense_adjacency(a, backward))``, but packed
        straight from the edge list, without the ``[n, n]`` bool plane (2.1
        GB at the dense tier's largest graphs).  It keeps the dense tier's
        gate all the same: past ``DENSE_ADJ_MAX_BYTES`` it raises
        ``MemoryError``, as the JAX package's packed build does.
        """
        n = self.n_nodes
        if n * n > DENSE_ADJ_MAX_BYTES:
            raise MemoryError(
                f"packed adjacency at n={n} belongs to the dense [n, n] tier "
                f"({n * n} bytes > budget {DENSE_ADJ_MAX_BYTES}); use the "
                "edge-list engines"
            )
        nw = bitops.packed_width(n)
        out = np.zeros(n * nw, np.uint32)
        e = self.edges_for_label(a)
        rows, cols = (e[:, 1], e[:, 0]) if backward else (e[:, 0], e[:, 1])
        # unique cells, sorted by (row, col): a repeated edge sets its bit
        # once, and the cells of one word are adjacent and carry distinct bits
        cell = np.sort(rows.astype(np.int64) * n + cols)
        if len(cell):
            cell = cell[np.r_[True, cell[1:] != cell[:-1]]]
            rows, cols = cell // n, cell % n
            word = rows * nw + (cols >> 5)
            bits = np.left_shift(np.uint32(1), (cols & 31).astype(np.uint32))
            starts = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
            out[word[starts]] = np.bitwise_or.reduceat(bits, starts)
        return out.reshape(n, nw)

    def summary_fwd(self, a: int) -> np.ndarray:
        """Paper's f^a: bool[n], bit i set iff node i has an outgoing a-edge."""
        e = self.edges_for_label(a)
        out = np.zeros(self.n_nodes, dtype=bool)
        out[e[:, 0]] = True
        return out

    def summary_bwd(self, a: int) -> np.ndarray:
        """Paper's b^a: bool[n], bit i set iff node i has an incoming a-edge."""
        e = self.edges_for_label(a)
        out = np.zeros(self.n_nodes, dtype=bool)
        out[e[:, 1]] = True
        return out


def _csr(src: np.ndarray, dst: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, src + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, dst.astype(np.int32)


def subgraph_triples(g: Graph, triple_mask: np.ndarray) -> Graph:
    """Graph restricted to the triples selected by ``triple_mask``."""
    return Graph(
        n_nodes=g.n_nodes,
        n_labels=g.n_labels,
        triples=g.triples[triple_mask],
        node_names=g.node_names,
        label_names=g.label_names,
    )


# --------------------------------------------------------------------- #
# deltas between snapshots (incremental maintenance; DESIGN.md Sect. 8)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """The difference between two consecutive graph snapshots.

    A mutation source (``repro_torch.db.GraphDB``) records one ``GraphDelta`` per
    version bump; the engine composes them to decide whether a superseded
    plan is *resumable* (dictionary and node axis unchanged — operands can
    be patched in place and the old fixpoint warm-starts the new solve) or
    *cold* (shape change: rebuild from scratch).  Triples are int id rows,
    valid in both snapshots whenever :attr:`shape_stable` holds (ids are
    stable across mutations; deletes never drop names).
    """

    inserted: np.ndarray  # (K, 3) int32 (src, label, dst) rows added
    deleted: np.ndarray  # (K, 3) int32 rows removed
    nodes_before: int
    nodes_after: int
    labels_before: int
    labels_after: int

    @property
    def shape_stable(self) -> bool:
        """True iff the dictionary did not grow: no new nodes or labels.

        Shape-stable deltas keep every compiled operand shape (chi width,
        dense/packed adjacency) and every name -> id mapping valid, which is
        the precondition for patching a plan instead of rebuilding it.
        """
        return (
            self.nodes_after == self.nodes_before
            and self.labels_after == self.labels_before
        )

    @property
    def has_insertions(self) -> bool:
        """True iff the delta adds edges (the fixpoint may *grow*)."""
        return len(self.inserted) > 0

    @property
    def n_changes(self) -> int:
        """Total number of edge insertions + deletions."""
        return len(self.inserted) + len(self.deleted)

    def touched_labels(self) -> set[int]:
        """Label ids with at least one inserted or deleted edge."""
        out: set[int] = set()
        if len(self.inserted):
            out.update(int(x) for x in np.unique(self.inserted[:, 1]))
        if len(self.deleted):
            out.update(int(x) for x in np.unique(self.deleted[:, 1]))
        return out

    def inserted_labels(self) -> set[int]:
        """Label ids with at least one *inserted* edge (these destabilize
        dependent SOI rows; deletions alone never do)."""
        if not len(self.inserted):
            return set()
        return {int(x) for x in np.unique(self.inserted[:, 1])}

    def compose(self, later: "GraphDelta") -> "GraphDelta":
        """The delta of applying ``self`` then ``later`` (cancelling an
        insert against a later delete of the same triple and vice versa)."""
        ins = {tuple(r) for r in self.inserted.tolist()}
        dele = {tuple(r) for r in self.deleted.tolist()}
        for r in later.inserted.tolist():
            t = tuple(r)
            if t in dele:
                dele.discard(t)
            else:
                ins.add(t)
        for r in later.deleted.tolist():
            t = tuple(r)
            if t in ins:
                ins.discard(t)
            else:
                dele.add(t)
        as_rows = lambda s: (
            np.asarray(sorted(s), dtype=np.int32).reshape(-1, 3)
        )
        return GraphDelta(
            inserted=as_rows(ins),
            deleted=as_rows(dele),
            nodes_before=self.nodes_before,
            nodes_after=later.nodes_after,
            labels_before=self.labels_before,
            labels_after=later.labels_after,
        )
