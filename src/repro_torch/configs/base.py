"""ArchSpec: the uniform contract between configs, the dry-run driver and
the card's smoke run.

Each spec exposes, per shape cell:

* ``abstract_state(cell)`` / ``abstract_inputs(cell)`` — trees of tensors
  on the ``meta`` device (no allocation; the full configs are only ever
  traced; the dual-simulation operands are fake CPU tensors instead).  A
  model's parameters are its module, built on ``meta``; the AdamW state
  is ``{"mu": [...], "nu": [...], "step"}`` in the module's parameter
  order.
* ``step(cell)``          — the step function: ``step(state, batch)``.
* ``state_shardings/input_shardings(mesh, cell)`` — trees of
  :class:`~repro_torch.distributed.shard.NamedSharding` with the state's
  and the inputs' paths (a module's parameters by name).
* ``model_flops(cell)``   — "useful" FLOPs (6·N·D train / 2·N·D inference;
  family-specific for GNN/recsys/dualsim) for the dry-run's
  MODEL_FLOPS / traced-FLOPs ratio.
* ``hlo_trip_factor(cell)`` / ``trip_schedule(cell)`` — the trip counts of
  the loops the port's trace of ``step`` does *not* unroll.  The port runs
  its layer and microbatch loops in Python, so a trace of one step holds
  every layer and microbatch and its factor is 1 (the JAX package's
  factors multiply the one scan body that XLA's cost analysis counts);
  only the dual-simulation fixpoint, a host loop that a trace cannot run to
  convergence, is traced one sweep and multiplied by the sweeps it stands
  for.
* ``reduced()``           — a tiny same-family config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.distributed import shard as sh
from repro_torch.distributed.shard import P
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import sampler as sampler_mod
from repro_torch.models import steps as steps_mod
from repro_torch.models import transformer as tr
from repro_torch.optimizer import adamw

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | dualsim
    batch: int = 0
    seq: int = 0
    microbatches: int = 1
    extras: dict = dataclasses.field(default_factory=dict)


def sds(shape, dtype) -> torch.Tensor:
    """An abstract tensor: ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=META)


def _with_opt(model: torch.nn.Module) -> dict:
    return {"params": model, "opt": adamw.init(list(model.parameters()))}


def _train_step(loss, opt: adamw.AdamWConfig, microbatches: int) -> Callable:
    """``train(state, batch) -> (state, metrics)`` over ``state = {"params":
    module, "opt": adamw state}``, which it updates in place."""
    inner = steps_mod.make_train_step(loss, opt, microbatches=microbatches)

    def train(state, batch):
        return state, inner(state["params"], state["opt"], batch)

    return train


def _opt_shardings(model: torch.nn.Module, params: dict, mesh) -> dict:
    """Each moment sharded as its parameter; the step replicated."""
    moments = [params[name] for name, _ in model.named_parameters()]
    return {"mu": moments, "nu": list(moments), "step": sh.NamedSharding(mesh, P())}


def _leaf_shardings(tree: dict, mesh, spec_of: Callable[[str, torch.Tensor], P]) -> dict:
    return sh.map_with_path(lambda path, leaf: sh.named(mesh, leaf.shape, spec_of(path, leaf)),
                            tree)


# ===================================================================== #
# LM family
# ===================================================================== #
LM_SHAPES = {
    # microbatches=8: 4 would halve FSDP gather traffic but blows the
    # 16 GiB/dev budget at 8B scale (the JAX package's finding).
    "train_4k": Cell("train_4k", "train", batch=256, seq=4096, microbatches=8),
    "prefill_32k": Cell("prefill_32k", "prefill", batch=32, seq=32768),
    "decode_32k": Cell("decode_32k", "decode", batch=128, seq=32768),
    "long_500k": Cell("long_500k", "decode", batch=1, seq=524288),
}


class LMArch:
    family = "lm"

    def __init__(self, cfg: tr.LMConfig, opt: adamw.AdamWConfig | None = None):
        self.id = cfg.name
        self.cfg = cfg
        self.opt = opt or adamw.AdamWConfig()

    def cells(self) -> dict[str, Cell]:
        return dict(LM_SHAPES)

    def skip_reason(self, cell_name: str) -> str | None:
        if cell_name == "long_500k" and self.cfg.full_attention:
            return (
                "long_500k requires sub-quadratic attention; "
                f"{self.id} uses full attention (see DESIGN.md)"
            )
        return None

    # -------------------------- state ------------------------------- #
    def _serve_cfg(self) -> tr.LMConfig:
        return dataclasses.replace(self.cfg, param_dtype=torch.bfloat16, remat=False)

    def abstract_params(self, serve: bool) -> tr.LM:
        return tr.LM(self._serve_cfg() if serve else self.cfg, META)

    def abstract_state(self, cell: Cell) -> dict:
        if cell.kind == "train":
            return _with_opt(self.abstract_params(serve=False))
        params = self.abstract_params(serve=True)
        if cell.kind == "decode":
            cfg = self._serve_cfg()
            s = min(cell.seq, cfg.sliding_window) if cfg.sliding_window else cell.seq
            kv = (cfg.n_layers, cell.batch, s, cfg.n_kv_heads, cfg.head_dim)
            cache = {"k": sds(kv, cfg.dtype), "v": sds(kv, cfg.dtype),
                     "pos": sds((cell.batch,), torch.int32)}
            return {"params": params, "cache": cache}
        return {"params": params}

    def abstract_inputs(self, cell: Cell) -> dict:
        if cell.kind == "train":
            return {
                "tokens": sds((cell.batch, cell.seq), torch.int32),
                "labels": sds((cell.batch, cell.seq), torch.int32),
            }
        if cell.kind == "prefill":
            return {"tokens": sds((cell.batch, cell.seq), torch.int32)}
        return {"tokens": sds((cell.batch, 1), torch.int32)}  # decode

    # -------------------------- step -------------------------------- #
    def step(self, cell: Cell) -> Callable:
        if cell.kind == "train":
            cfg = self.cfg
            return _train_step(lambda p, b: tr.loss_fn(cfg, p, b), self.opt,
                               cell.microbatches)
        scfg = self._serve_cfg()
        if cell.kind == "prefill":

            def prefill(state, batch):
                return tr.prefill_step(scfg, state["params"], batch["tokens"])

            return prefill

        def decode(state, batch):
            return tr.decode_step(scfg, state["params"], state["cache"], batch["tokens"])

        return decode

    # ------------------------ shardings ----------------------------- #
    def state_shardings(self, mesh, cell: Cell) -> dict:
        rules = sh.lm_param_rules(self.cfg, mesh)
        state = self.abstract_state(cell)
        params = sh.shard_by_rules(state["params"], mesh, rules)
        out = {"params": params}
        if "opt" in state:
            out["opt"] = _opt_shardings(state["params"], params, mesh)
        if "cache" in state:
            specs = sh.lm_cache_spec(mesh, self.cfg, cell.batch, cell.seq)
            out["cache"] = {k: sh.named(mesh, leaf.shape, specs[k])
                            for k, leaf in state["cache"].items()}
        return out

    def input_shardings(self, mesh, cell: Cell) -> dict:
        bs = sh.batch_spec(mesh, cell.batch)
        return _leaf_shardings(self.abstract_inputs(cell), mesh,
                               lambda path, leaf: P(*bs, None))

    def model_flops(self, cell: Cell) -> float:
        n = self.cfg.active_param_count()
        if cell.kind == "train":
            return 6.0 * n * cell.batch * cell.seq
        if cell.kind == "prefill":
            return 2.0 * n * cell.batch * cell.seq
        return 2.0 * n * cell.batch  # decode: one token per sequence

    def hlo_trip_factor(self, cell: Cell) -> float:
        """1: the trace unrolls every layer and microbatch (module doc)."""
        return 1.0

    def trip_schedule(self, cell: Cell) -> list[float]:
        """No loop of the step is left out of the trace."""
        return []

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

    def skip_reason(self, cell_name: str) -> str | None:
        return None

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

    def abstract_state(self, cell: Cell) -> dict:
        cfg = self.cell_cfg(cell)
        return _with_opt(gnn_mod.MODULES[cfg.arch](cfg, META))

    def abstract_inputs(self, cell: Cell) -> dict:
        n, e, g = self._shapes(cell)
        ex = cell.extras
        feat = (
            sds((n,), torch.int32)
            if self.id == "schnet" and ex["task"] == "graph_reg"
            else sds((n, ex["d_feat"]), torch.float32)
        )
        labels = (
            sds((g,), torch.float32)
            if ex["task"] == "graph_reg"
            else sds((n,), torch.int32)
        )
        out = {
            "feat": feat,
            "edges": sds((e, 2), torch.int32),
            "edge_mask": sds((e,), torch.bool),
            "labels": labels,
            "node_graph": sds((n,), torch.int32),
        }
        if self.id == "schnet":
            out["positions"] = sds((n, 3), torch.float32)
        return out

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

        return _train_step(loss, self.opt, 1)

    def state_shardings(self, mesh, cell: Cell) -> dict:
        state = self.abstract_state(cell)
        return sh.map_with_path(lambda path, leaf: sh.NamedSharding(mesh, P()), state)

    def input_shardings(self, mesh, cell: Cell) -> dict:
        specs = sh.gnn_input_specs(mesh)
        return _leaf_shardings(self.abstract_inputs(cell), mesh,
                               lambda path, leaf: specs.get(path, P()))

    def model_flops(self, cell: Cell) -> float:
        n, e, _ = self._shapes(cell)
        cfg = self.cell_cfg(cell)
        d = cfg.d_hidden
        # messages over edges + node transforms, x3 for fwd+bwd
        per_layer = 2.0 * e * d + 4.0 * n * d * d
        return 3.0 * cfg.n_layers * per_layer

    def hlo_trip_factor(self, cell: Cell) -> float:
        """1: the trace unrolls every layer (module doc)."""
        return 1.0

    def trip_schedule(self, cell: Cell) -> list[float]:
        """No loop of the step is left out of the trace."""
        return []

    def reduced(self) -> gnn_mod.GNNConfig:
        return dataclasses.replace(
            self.base_cfg, n_layers=2, d_hidden=16, d_in=8, n_out=3, n_rbf=16
        )


# ===================================================================== #
# RecSys family
# ===================================================================== #
REC_SHAPES = {
    "train_batch": Cell("train_batch", "train", batch=65536, microbatches=4),
    "serve_p99": Cell("serve_p99", "serve", batch=512),
    "serve_bulk": Cell("serve_bulk", "serve", batch=262144),
    "retrieval_cand": Cell(
        "retrieval_cand", "retrieval", batch=1,
        extras=dict(n_candidates=1_000_000),
    ),
}


class RecsysArch:
    family = "recsys"

    def __init__(self, cfg: rec_mod.RecsysConfig,
                 opt: adamw.AdamWConfig | None = None):
        self.id = cfg.name
        self.cfg = cfg
        self.opt = opt or adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)

    def cells(self) -> dict[str, Cell]:
        return dict(REC_SHAPES)

    def skip_reason(self, cell_name: str) -> str | None:
        return None

    def abstract_state(self, cell: Cell) -> dict:
        params = rec_mod.Recsys(self.cfg, META)
        if cell.kind == "train":
            return _with_opt(params)
        return {"params": params}

    def abstract_inputs(self, cell: Cell) -> dict:
        b = cell.batch
        out = {
            "dense": sds((b, self.cfg.n_dense), torch.float32),
            "sparse": sds((b, self.cfg.n_sparse), torch.int32),
        }
        if cell.kind == "train":
            out["labels"] = sds((b,), torch.float32)
        if cell.kind == "retrieval":
            out["candidates"] = sds(
                (cell.extras["n_candidates"], self.cfg.mlp[-1]), torch.float32
            )
        return out

    def step(self, cell: Cell) -> Callable:
        cfg = self.cfg
        if cell.kind == "train":
            return _train_step(lambda p, b: rec_mod.loss_fn(cfg, p, b), self.opt,
                               cell.microbatches)
        if cell.kind == "retrieval":

            def retrieve(state, batch):
                return rec_mod.retrieval_score(cfg, state["params"], batch)

            return retrieve

        def serve(state, batch):
            return torch.sigmoid(rec_mod.forward(cfg, state["params"], batch))

        return serve

    def state_shardings(self, mesh, cell: Cell) -> dict:
        rules = sh.recsys_param_rules(self.cfg)
        state = self.abstract_state(cell)
        params = sh.shard_by_rules(state["params"], mesh, rules)
        out = {"params": params}
        if "opt" in state:
            out["opt"] = _opt_shardings(state["params"], params, mesh)
        return out

    def input_shardings(self, mesh, cell: Cell) -> dict:
        bs = sh.batch_spec(mesh, cell.batch)

        def spec_of(path, leaf):
            if path == "candidates":
                return P(("data", "model"), None)
            return P(*bs, None) if leaf.dim() == 2 else P(*bs)

        return _leaf_shardings(self.abstract_inputs(cell), mesh, spec_of)

    def model_flops(self, cell: Cell) -> float:
        cfg = self.cfg
        d = cfg.d_interact
        widths = [d] + list(cfg.mlp)
        mlp = sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))
        per_ex = cfg.n_cross * 2 * d * d + mlp
        b = cell.batch
        mult = 3.0 if cell.kind == "train" else 1.0
        flops = mult * b * per_ex
        if cell.kind == "retrieval":
            flops += 2.0 * cell.extras["n_candidates"] * cfg.mlp[-1] * b
        return flops

    def hlo_trip_factor(self, cell: Cell) -> float:
        """1: the trace unrolls every microbatch (module doc)."""
        return 1.0

    def trip_schedule(self, cell: Cell) -> list[float]:
        """No loop of the step is left out of the trace."""
        return []

    def reduced(self) -> rec_mod.RecsysConfig:
        return dataclasses.replace(
            self.cfg, vocab_sizes=(97, 31, 53), n_sparse=3, n_dense=4,
            embed_dim=8, mlp=(32, 16),
        )
