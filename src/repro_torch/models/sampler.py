"""Neighbor sampler for the ``minibatch_lg`` GNN shape (fanout 15-10).

A real GraphSAGE-style layered sampler over a CSR index: per seed node,
sample up to ``fanout[0]`` in-neighbors, then ``fanout[1]`` per frontier
node.  Emits a *fixed-shape* padded local subgraph (jit-stable): local node
ids, local edge index, edge mask, and the seed labels.  Numpy-side — this is
the host data pipeline feeding the device step.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SampledBlock:
    node_ids: np.ndarray  # [Nmax] global ids (padded with 0)
    node_mask: np.ndarray  # [Nmax] bool
    edges: np.ndarray  # [Emax, 2] local (src, dst), padded with 0
    edge_mask: np.ndarray  # [Emax] bool
    n_seeds: int


def block_sizes(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """Padded (Nmax, Emax) for a given batch size and fanout."""
    n, e, frontier = batch_nodes, 0, batch_nodes
    for f in fanout:
        e += frontier * f
        frontier *= f
        n += frontier
    return n, e


class NeighborSampler:
    def __init__(self, n_nodes: int, edges: np.ndarray, seed: int = 0):
        """edges: [E, 2] (src, dst); sampling walks dst -> in-neighbors."""
        order = np.argsort(edges[:, 1], kind="stable")
        self._src = edges[order, 0].astype(np.int64)
        dst = edges[order, 1]
        self._ptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(self._ptr, dst + 1, 1)
        np.cumsum(self._ptr, out=self._ptr)
        self._rng = np.random.default_rng(seed)
        self.n_nodes = n_nodes

    def sample(self, seeds: np.ndarray, fanout: tuple[int, ...]) -> SampledBlock:
        nmax, emax = block_sizes(len(seeds), fanout)
        local: dict[int, int] = {int(s): i for i, s in enumerate(seeds)}
        nodes = list(int(s) for s in seeds)
        e_src: list[int] = []
        e_dst: list[int] = []
        frontier = list(int(s) for s in seeds)
        for f in fanout:
            nxt: list[int] = []
            for u in frontier:
                lo, hi = self._ptr[u], self._ptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, int(deg))
                picks = self._rng.choice(int(deg), size=take, replace=False)
                for nb in self._src[lo + picks]:
                    nb = int(nb)
                    if nb not in local:
                        local[nb] = len(nodes)
                        nodes.append(nb)
                    nxt.append(nb)
                    e_src.append(local[nb])
                    e_dst.append(local[u])
            frontier = nxt

        node_ids = np.zeros(nmax, dtype=np.int64)
        node_ids[: len(nodes)] = nodes
        node_mask = np.zeros(nmax, dtype=bool)
        node_mask[: len(nodes)] = True
        edges = np.zeros((emax, 2), dtype=np.int32)
        edges[: len(e_src), 0] = e_src
        edges[: len(e_src), 1] = e_dst
        edge_mask = np.zeros(emax, dtype=bool)
        edge_mask[: len(e_src)] = True
        return SampledBlock(
            node_ids=node_ids,
            node_mask=node_mask,
            edges=edges,
            edge_mask=edge_mask,
            n_seeds=len(seeds),
        )
