"""DBpedia-shaped data: many predicates of Zipf-skewed sizes, and hub nodes.

Mennicke, Kalo, Nitzschke and Balke, "Fast Dual Simulation Processing of
Graph Database Queries" (ICDE 2019), run their DBpedia instance at 751M
triples over 65,430 predicates and 216M nodes.  This generator keeps the
predicates whole and cuts the triples and the nodes (the configuration's
``triples`` and ``nodes``):

* predicate ``p<r>`` (rank ``r`` from 0, so ``p0`` is the largest) holds a
  share of the drawn triples proportional to ``1 / (r + 1) ** s``, ``s`` the
  configuration's ``predicate_exponent``: the whole part of its exact share,
  and one triple more for as many ranks as the rounding left over, drawn
  from the configuration's fixed ``size_seed`` with the fractional parts as
  weights, so every run holds the same counts;
* subjects and objects are drawn independently, the node of rank ``k`` with
  weight ``1 / (k + 1) ** z``, ``z`` the ``endpoint_exponent``, over one
  permutation of the nodes drawn from ``size_seed``: the same node is the
  busiest subject and the busiest object in every run, and the run's seed
  draws every endpoint, the wiring;
* repeated triples are dropped (RDF is a set); nodes are named ``n<id>``.
"""
from __future__ import annotations

import numpy as np

from . import Corpus, dedupe


def zipf_weights(n: int, exponent: float) -> np.ndarray:
    """Weights of ranks ``0 .. n - 1``, proportional to ``1 / (rank + 1) **
    exponent`` and summing to 1."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
    return w / w.sum()


def predicate_counts(cfg: dict) -> np.ndarray:
    """Drawn triples of each predicate by rank, from ``size_seed`` alone:
    each rank's exact Zipf share rounded down, and the triples the rounding
    left over given, one each, to ranks drawn without replacement with their
    fractional parts as weights."""
    size = np.random.default_rng(cfg["size_seed"])
    exact = cfg["triples"] * zipf_weights(cfg["predicates"], cfg["predicate_exponent"])
    counts = np.floor(exact).astype(np.int64)
    frac = exact - counts
    left = int(cfg["triples"] - counts.sum())
    if left:
        counts[size.choice(len(counts), left, replace=False, p=frac / frac.sum())] += 1
    return counts


def node_order(cfg: dict) -> np.ndarray:
    """Node ids by endpoint rank: ``node_order(cfg)[0]`` is the hub.  A
    permutation drawn from ``size_seed``, on a stream apart from the
    predicate counts' draws."""
    return np.random.default_rng([cfg["size_seed"], 1]).permutation(cfg["nodes"])


def _endpoints(n: int, cdf: np.ndarray, order: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
    """``n`` node ids drawn independently by rank weight (``cdf`` the
    cumulative weights of the ranks; the clip holds a draw that rounds up
    to the last weight on the last rank)."""
    rank = np.searchsorted(cdf, rng.random(n) * cdf[-1], side="right")
    return order[np.minimum(rank, len(order) - 1)]


def generate(cfg: dict, rng: np.random.Generator) -> Corpus:
    n_nodes, n_labels = cfg["nodes"], cfg["predicates"]
    counts = predicate_counts(cfg)
    order = node_order(cfg)
    cdf = np.cumsum(zipf_weights(n_nodes, cfg["endpoint_exponent"]))
    drawn = int(counts.sum())
    labels = np.repeat(np.arange(n_labels, dtype=np.int64), counts)
    subjects = _endpoints(drawn, cdf, order, rng)
    objects = _endpoints(drawn, cdf, order, rng)
    triples = dedupe(np.stack([subjects, labels, objects], 1), n_nodes, n_labels)
    triples = triples.astype(np.int32)
    used = np.count_nonzero(np.bincount(triples[:, 1], minlength=n_labels))
    corpus_counts = {"triples drawn": drawn, "triples": len(triples), "nodes": n_nodes,
                     "predicates": n_labels, "predicates used": int(used)}
    return Corpus(triples=triples, node_names=[f"n{i}" for i in range(n_nodes)],
                  label_names=[f"p{r}" for r in range(n_labels)], pools={},
                  counts=corpus_counts)
