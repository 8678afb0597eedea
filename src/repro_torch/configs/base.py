"""ArchSpecs of the LM and GNN families: the full config (``.cfg`` /
``.base_cfg``) and a tiny same-family config for CPU smoke tests
(``.reduced()``).  The GNN family also has the JAX package's shape cells
(``cells``, ``cell_cfg``), its train step per cell (``step``) and its
model-FLOP count.  The shardings and dry-run hooks (``abstract_state``,
``abstract_inputs``, ``*_shardings``, ``hlo_trip_factor``) are not ported."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import gnn as gnn_mod
from repro_torch.models import sampler as sampler_mod
from repro_torch.models import steps as steps_mod
from repro_torch.models import transformer as tr
from repro_torch.optimizer import adamw


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | dualsim
    batch: int = 0
    seq: int = 0
    microbatches: int = 1
    extras: dict = dataclasses.field(default_factory=dict)


# ===================================================================== #
# LM family
# ===================================================================== #
class LMArch:
    family = "lm"

    def __init__(self, cfg: tr.LMConfig):
        self.id = cfg.name
        self.cfg = cfg

    def reduced(self) -> tr.LMConfig:
        return dataclasses.replace(
            self.cfg,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.cfg.n_kv_heads // self.cfg.n_heads),
            d_ff=128,
            vocab=128,
            head_dim=16,
            sliding_window=8 if self.cfg.sliding_window else None,
            moe=dataclasses.replace(self.cfg.moe, n_experts=4, top_k=2, d_expert=32)
            if self.cfg.moe
            else None,
            dtype=torch.float32,
            remat=False,
        )


# ===================================================================== #
# GNN family
# ===================================================================== #
GNN_SHAPES = {
    "full_graph_sm": Cell(
        "full_graph_sm", "train",
        extras=dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7,
                    task="node_class", n_graphs=1),
    ),
    "minibatch_lg": Cell(
        "minibatch_lg", "train",
        extras=dict(batch_nodes=1024, fanout=(15, 10), d_feat=602, n_out=41,
                    task="node_class", n_graphs=1),
    ),
    "ogb_products": Cell(
        "ogb_products", "train",
        extras=dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                    n_out=47, task="node_class", n_graphs=1),
    ),
    "molecule": Cell(
        "molecule", "train",
        extras=dict(n_graphs=128, nodes_per=30, edges_per=64, d_feat=1,
                    n_out=1, task="graph_reg"),
    ),
}


class GNNArch:
    family = "gnn"

    def __init__(self, arch_id: str, base_cfg: gnn_mod.GNNConfig,
                 opt: adamw.AdamWConfig | None = None):
        self.id = arch_id
        self.base_cfg = base_cfg
        self.opt = opt or adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)

    def cells(self) -> dict[str, Cell]:
        return dict(GNN_SHAPES)

    def cell_cfg(self, cell: Cell) -> gnn_mod.GNNConfig:
        ex = cell.extras
        return dataclasses.replace(
            self.base_cfg,
            d_in=ex["d_feat"],
            n_out=ex["n_out"],
            task=ex["task"],
            # bf16 activations at full-batch-large scale
            dtype=torch.bfloat16 if cell.name == "ogb_products" else torch.float32,
        )

    def _shapes(self, cell: Cell) -> tuple[int, int, int]:
        ex = cell.extras
        if cell.name == "minibatch_lg":
            n, e = sampler_mod.block_sizes(ex["batch_nodes"], ex["fanout"])
        elif cell.name == "molecule":
            g = ex["n_graphs"]
            n, e = g * ex["nodes_per"], g * ex["edges_per"]
            return n, e, g
        else:
            n, e = ex["n_nodes"], ex["n_edges"]
        # pad node/edge counts to a 512 multiple so every mesh axis divides;
        # padding rides in masked edges / isolated dummy nodes (edge_mask).
        pad = lambda x: -(-x // 512) * 512  # noqa: E731
        return pad(n), pad(e), 1

    def step(self, cell: Cell) -> Callable[[dict, dict], tuple[dict, dict]]:
        """``train(state, batch) -> (state, metrics)`` over ``state =
        {"params": module, "opt": adamw state}``, which it updates in place
        and hands back."""
        cfg = self.cell_cfg(cell)
        ex = cell.extras

        def loss(params, batch):
            b = dict(batch)
            if cfg.task == "graph_reg":
                b["n_graphs"] = ex["n_graphs"]
            if "positions" not in b:
                b["positions"] = torch.zeros((b["feat"].shape[0], 3), dtype=torch.float32,
                                             device=b["feat"].device)
            return gnn_mod.loss_fn(cfg, params, b)

        inner = steps_mod.make_train_step(loss, self.opt, microbatches=1)

        def train(state, batch):
            metrics = inner(state["params"], state["opt"], batch)
            return state, metrics

        return train

    def model_flops(self, cell: Cell) -> float:
        n, e, _ = self._shapes(cell)
        cfg = self.cell_cfg(cell)
        d = cfg.d_hidden
        # messages over edges + node transforms, x3 for fwd+bwd
        per_layer = 2.0 * e * d + 4.0 * n * d * d
        return 3.0 * cfg.n_layers * per_layer

    def reduced(self) -> gnn_mod.GNNConfig:
        return dataclasses.replace(
            self.base_cfg, n_layers=2, d_hidden=16, d_in=8, n_out=3, n_rbf=16
        )
