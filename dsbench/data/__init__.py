"""Data generators, one module per configuration ``generator`` key.

Each module has ``generate(config, rng) -> Corpus``; the harness imports
``dsbench.data.<generator>`` by the name the configuration file gives.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Corpus:
    """Generated triples with their dictionaries, and named id pools that
    traffic mixes draw constants from."""

    triples: np.ndarray  # (E, 3) int32 (subject, label, object)
    node_names: list[str]
    label_names: list[str]
    pools: dict[str, np.ndarray]  # pool name -> node ids
    counts: dict[str, int]  # what was generated, for the run's record

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    def pool(self, name: str) -> np.ndarray:
        """Node ids of a named pool; ``objects:<label>`` is computed on
        first use as the distinct objects of that label's triples."""
        if name not in self.pools:
            kind, _, arg = name.partition(":")
            if kind != "objects":
                raise KeyError(f"no pool {name!r}")
            a = self.label_names.index(arg)
            self.pools[name] = np.unique(self.triples[self.triples[:, 1] == a, 2])
        return self.pools[name]


def dedupe(triples: np.ndarray, n_nodes: int, n_labels: int) -> np.ndarray:
    """Distinct triples (RDF is a set), kept in their first order."""
    if n_nodes * n_nodes * n_labels >= 1 << 62:
        raise ValueError("ids past the dedupe key's width")
    t = triples.astype(np.int64)
    _, first = np.unique((t[:, 0] * n_labels + t[:, 1]) * n_nodes + t[:, 2],
                         return_index=True)
    return np.ascontiguousarray(triples[np.sort(first)])
