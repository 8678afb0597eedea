"""Sharded paths of the port on a real multi-rank gloo group, held against
their plain versions on one process.

The production dry-run traces every sharded step over a fake process group
that moves no data, so only a group whose ranks exchange real values shows
whether a sharded step computes what the plain step computes.  Each world
size below spawns one gloo group for this module
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous in a temporary
directory, one thread a rank so that the suite's other workers keep their
cores); every case of that world size runs in the group in turn, and rank 0
hands the results back through a file, with what every rank holds after
each case (``dist.all_gather_object``).  Two ranks form a 1-D ``(data,)``
mesh (a ``(1, 2)`` ``(data, model)`` mesh for the LM and recsys cases,
whose rules name both axes); four ranks the 2 x 2 ``(data, model)`` mesh.
``tests/test_torch_multipod.py`` runs these case builders and checks on
eight ranks, the 2 x 2 x 2 ``(pod, data, model)`` mesh of the
``multipod`` rules, in a module of its own (so that ``--dist loadfile``
runs it on another worker).

What is held, and at what tolerance:

* ``ctx.segment_reduce``'s max and min, edges split across the ranks: the
  values and the gradient equal ``scatter_reduce``'s on one process
  exactly (the gradient goes only to edges equal to their segment's
  extreme over every shard, split evenly among ties), and on random inputs
  with ties the JAX package's ``jax.grad`` of ``segment_max`` /
  ``segment_min`` within f32 rtol 1e-5;
* PNA's and GAT's ``reduced()`` configs, one ``GNNArch.step`` with the edges
  sharded, against the plain step on one process: in f32 the step's loss
  and gradient norm within rtol 1e-5; in f64 (activations and parameters)
  the loss within rtol 1e-5 (``loss_fn`` takes it in f32), and the
  gradient norm and every gradient within rtol 1e-12, atol 1e-14.  Every
  gradient is held in f64 because PNA's ``sqrt(var)`` aggregator
  multiplies the f32 rounding of a reordered segment sum by up to
  ``1 / (2 sqrt(1e-6))`` = 500 where a variance sits at its clamp: an f32
  element-wise bound would measure the summation order, not the sharding;
* gatedgcn and schnet (with random positions) held as PNA and GAT are,
  but for the step's gradient norm, which ``adamw.global_norm`` sums in
  f32 in either dtype: within f32 rtol 1e-5 (an f64 gradient a few ulps
  off rounds to another f32 value, and the norm moves by ~1e-7);
* the four GNNs on the ``molecule`` cell (``MOLECULE_CELL``: 8 graphs of
  30 nodes and 64 edges, real ``node_graph`` ids, the ``graph_reg``
  readout; schnet on int32 atom types): loss and gradient norm within f32
  rtol 1e-5, and in f64 every gradient within rtol 1e-12, atol 1e-14;
* one ``sparse`` dual-simulation sweep of the ``q_sparse`` cell with the
  edges and chi's columns sharded: chi's packed words bit for bit equal to
  the one-rank sweep's;
* one sweep of the ``q_partitioned`` cell over DTensor blocks: chi's words
  bit for bit;
* the same ``q_sparse`` and ``q_partitioned`` sweeps, and the
  query-parallel batch below, with each shard's edges in the blocked layout
  that ``DualsimArch.place`` builds for a card (run here through the
  kernel wrapper's plain version): bit for bit, and a ``sparse`` sweep over
  DTensor operands without ``chi_spec`` refused;
* on the 2 x 2 mesh, a query-parallel ``sparse`` batch of two queries
  (``batch16_sparse``'s ``chi_spec``: the query variables over ``data``,
  which splits one query's variables across shards, the words over
  ``model``, on a node count whose shards do not align with the words):
  one sweep, and the whole fixpoint in both sweep orders, bit for bit and
  in as many sweeps;
* the dense LMs' (internlm2, and qwen3, whose shards slice one replicated
  key/value head) and the MoE LM's ``reduced()`` train step (``_attend``,
  ``_moe_sharded``) against the same step on the plain state under the
  same rules (so the MoE blocks its tokens into the same groups): f32
  loss and gradient norm within rtol 1e-5, every gradient within rtol
  1e-4 (atol 1e-4 times its largest magnitude, for elements near zero, as
  ``test_torch_lm.py`` holds them), and every rank's MoE dispatch (each slot's expert, token and
  position, and each expert's count) equal exactly to the plain
  dispatch of the groups that rank holds;
* dcn-v2's train step with the embedding table's rows sharded, so that
  ``ctx.lookup`` runs shard-local: loss and gradient norm rtol 1e-5,
  gradients as the LM's;
* dcn-v2's serving cells on the state and inputs their shardings place:
  ``serve_p99`` and ``serve_bulk`` (``RecsysArch.step``'s sigmoid, batch
  16 and 64) within f32 rtol 1e-5, and ``retrieval_cand`` over 512
  candidates split over ``(data, model)`` (``torch.topk`` over the split
  dim): the scores within rtol 1e-5 and the top 100 indices exactly, on
  candidates drawn so that no two scores tie; the outputs' placements
  stated;
* the serving steps of internlm2, qwen3, olmoe and mixtral (``reduced()``,
  f32; mixtral's 8-position window, so each decode step's roll crosses a
  shard boundary): ``prefill_step`` on ``LM_BATCH x LM_SEQ`` tokens and
  three ``decode_step``s, on the state ``LMArch.state_shardings`` places,
  against the plain steps under the same rules: each step's logits and
  the whole cache within rtol 1e-5 (atol 1e-5 times the largest
  magnitude, for elements near zero), ``pos`` exactly, and the cache's
  and ``pos``'s placements after prefill and after every step equal to
  ``lm_cache_spec``'s (batch over ``data``, sequence over ``model``); and
  on the 2 x 2 mesh at batch 1 for internlm2 and mixtral, the sequence
  over ``(data, model)`` in 4 shards (the MoE's expert weights kept
  where they lie, ``_moe_sharded`` without gradients);
* one ``block_dense`` sweep (``solve_dense``) over the operands
  ``DualsimArch.place`` puts on the mesh: chi bit for bit;
* replica agreement, bit for bit, in every group: after each case every
  rank records (``_record``) its local shard of every parameter, optimizer
  moment and gradient and of every output (loss, metrics, logits, chi,
  cache), with the mesh dims that split it (a ``Shard`` or a
  ``Partial``), and each scalar metric as it reads it whole; any two ranks
  at the same coordinate on every dim that splits a tensor hold bit-equal
  local tensors, and every rank reads bit-equal metrics.  This is the
  check that DTensor's warning about sequential collectives over several
  mesh dims ("may give inconsistent results between ranks") calls for: a
  replica that drifts from its twins by one rounding drifts further every
  step, and a comparison of rank 0 with the plain step cannot show it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import os

import numpy as np
import pytest
import torch

from repro_torch.distributed.shard import P

SEED = 0
# the ROADMAP's example: edges split 2 / 2, segment 0 = {1, 3}, segment 1 = {5, 2}
EXAMPLE = dict(vals=[1.0, 5.0, 3.0, 2.0], idx=[0, 1, 0, 1], n=2)
# segment 0's extreme 4 on three edges over both shards; segment 1 alone
TIES = dict(vals=[4.0, 1.0, 4.0, 4.0], idx=[0, 1, 0, 0], n=2, weight=[2.0, 3.0])
# segment 2 has no edge
EMPTY = dict(vals=[1.0, 5.0, 3.0, 2.0], idx=[0, 1, 0, 1], n=3, weight=[1.0, 1.0, 1.0])
GNN_ARCHS = ("pna", "gat-cora")
MORE_GNN_ARCHS = ("gatedgcn", "schnet")
# a node-classification cell cut to a few hundred nodes (padded to 512 by
# GNNArch._shapes, so every mesh axis divides it)
GNN_CELL = dict(n_nodes=300, n_edges=1500, d_feat=12, n_out=3, task="node_class", n_graphs=1)
QUERY = "{ ?a p0 ?b . ?b p1 ?c . ?c p0 ?d }"
# a query-parallel batch: 3 + 5 variables, so the 2-way row split cuts the
# second query's variables across shards
BATCH_QUERIES = ("{ ?a p0 ?b . ?b p1 ?c }",
                 "{ ?a p1 ?b . ?b p0 ?c . ?c p1 ?d . ?d p0 ?e }")
# qwen3's reduced() config has one key/value head for four query heads, so a
# shard's two query heads share it: the replicated, sliced kv branch
LM_ARCHS = ("internlm2-1.8b", "qwen3-8b", "olmoe-1b-7b")
LM_BATCH, LM_SEQ = 4, 16
# mixtral's reduced() config has an 8-position window: the prefill cache
# holds 8 positions, 4 or 2 a shard, so every decode step's roll moves a
# position across a shard boundary
SERVE_ARCHS = LM_ARCHS + ("mixtral-8x7b",)
SERVE_ONE_ARCHS = ("internlm2-1.8b", "mixtral-8x7b")  # batch 1: the sequence over (data, model)
DECODE_STEPS = 3
RECSYS_BATCH = 16
RECSYS_VOCAB = (96, 32, 52)  # 180 table rows: every mesh here divides them
# dcn-v2's serving cells cut to size: serve_p99's and serve_bulk's batches,
# and retrieval_cand's candidates
SERVE_BATCHES = {"serve_p99": 16, "serve_bulk": 64}
N_CANDIDATES = 512
# the molecule cell cut to 8 graphs of 30 nodes and 64 edges (240 nodes and
# 512 edges: every mesh here divides both)
MOLECULE_CELL = dict(n_graphs=8, nodes_per=30, edges_per=64, d_feat=1, n_out=1,
                     task="graph_reg")
# the 8-rank group holds each GNN's f64 gradients on one cell, the 2- and
# 4-rank groups on both: on the 2 x 2 x 2 mesh an f64 pass costs as much as
# the f32 one (DTensor's sharding propagation runs afresh for a new dtype)
F64_ON_8 = {"gnn": GNN_ARCHS, "molecule": MORE_GNN_ARCHS}
# each world size's mesh
MESHES = {2: ((2,), ("data",)), 4: ((2, 2), ("data", "model")),
          8: ((2, 2, 2), ("pod", "data", "model"))}


def _record(held: dict, mesh, what: str, tree) -> None:
    """Keep in ``held``, for the replica check, what this rank holds of
    ``tree`` (a tree of tensors, DTensors and numbers): ``held[what]`` is
    this rank's mesh coordinate and, by path, each leaf's local tensor and
    the mesh dims that split it (those where its placement is a ``Shard``
    or a ``Partial``; a plain tensor is split by none).  A case returns its
    ``held`` under the key ``"held"``, which ``_rank`` gathers."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import shard as sh

    leaves = {}
    for path, leaf in sh.leaves_with_path(tree):
        split = ()
        if isinstance(leaf, DTensor):
            split = tuple(k for k, p in enumerate(leaf.placements) if not p.is_replicate())
            leaf = leaf.to_local()
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().numpy()
        elif not isinstance(leaf, (int, float, np.ndarray)):
            continue
        leaves[path] = (split, np.array(leaf, copy=True))
    held[what] = (tuple(mesh.get_coordinate()), leaves)


def _random_case(world: int) -> dict:
    """Values drawn from a few integers (so that maxima tie within and
    across shards), ids over 12 segments of which the last two are empty,
    and a weight per output element."""
    rng = np.random.default_rng(SEED + world)
    e = 24 * world
    return dict(vals=rng.integers(0, 4, (e, 3)).astype(np.float32),
                idx=rng.integers(0, 10, e).astype(np.int64), n=12,
                weight=rng.standard_normal((12, 3)).astype(np.float32))


# --------------------------------------------------------------------- #
# the cases, run on every rank of the group
# --------------------------------------------------------------------- #
def _seg_reduce(mesh, case: dict, reduce: str) -> dict:
    """``segment_reduce`` over edges sharded on every mesh dim, read back
    whole; the gradient of ``sum(weight * out)`` (±inf read as 0, as
    ``gnn._seg_extreme`` does)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import ctx

    shard, rep = [Shard(0)] * mesh.ndim, [Replicate()] * mesh.ndim
    vals = torch.as_tensor(np.asarray(case["vals"], np.float32))
    v = distribute_tensor(vals, mesh, shard).requires_grad_()
    i = distribute_tensor(torch.as_tensor(np.asarray(case["idx"], np.int64)), mesh, shard)
    weight = case.get("weight", np.ones((case["n"], *vals.shape[1:]), np.float32))
    w = distribute_tensor(torch.as_tensor(np.asarray(weight, np.float32)), mesh, rep)
    out = ctx.segment_reduce(v, i, case["n"], reduce).redistribute(mesh, rep)
    (torch.where(torch.isfinite(out), out, torch.zeros_like(out)) * w).sum().backward()
    held = {}
    _record(held, mesh, "out", {"out": out, "grad": v.grad})
    return dict(out=out.full_tensor().detach().numpy(), grad=v.grad.full_tensor().numpy(),
                held=held)


def _molecule_batch(arch, cell) -> dict:
    """A batch of the molecule cell's graphs: each graph's random edges
    among its own nodes, ``node_graph`` its graph's id, a real-valued label
    a graph, and for schnet int32 atom types and random positions."""
    n, e, g = arch._shapes(cell)
    ex = cell.extras
    per = ex["nodes_per"]
    rng = np.random.default_rng(SEED)
    first = (np.arange(g) * per)[:, None, None]
    edges = (rng.integers(0, per, (g, ex["edges_per"], 2)) + first).reshape(e, 2)
    if arch.id == "schnet":
        feat = rng.integers(0, 10, n).astype(np.int32)
    else:
        feat = rng.standard_normal((n, ex["d_feat"]), dtype=np.float32)
    out = {"feat": torch.as_tensor(feat),
           "edges": torch.as_tensor(edges.astype(np.int32)),
           "edge_mask": torch.ones(e, dtype=torch.bool),
           "labels": torch.as_tensor(rng.standard_normal(g, dtype=np.float32)),
           "node_graph": torch.as_tensor(np.repeat(np.arange(g, dtype=np.int32), per))}
    if arch.id == "schnet":
        out["positions"] = torch.as_tensor(rng.standard_normal((n, 3), dtype=np.float32))
    return out


def _gnn_batch(arch, cell) -> dict:
    """A batch at the cell's padded shapes: random edges among the real
    nodes, the padding masked; labels -1 on padded nodes (the molecule
    cell: :func:`_molecule_batch`)."""
    if cell.extras["task"] == "graph_reg":
        return _molecule_batch(arch, cell)
    n, e, _ = arch._shapes(cell)
    ex = cell.extras
    rng = np.random.default_rng(SEED)
    edges = np.zeros((e, 2), np.int32)
    edges[:ex["n_edges"]] = rng.integers(0, ex["n_nodes"], (ex["n_edges"], 2))
    labels = np.full(n, -1, np.int32)
    labels[:ex["n_nodes"]] = rng.integers(0, ex["n_out"], ex["n_nodes"])
    out = {"feat": torch.as_tensor(rng.standard_normal((n, ex["d_feat"]), dtype=np.float32)),
           "edges": torch.as_tensor(edges),
           "edge_mask": torch.as_tensor(np.arange(e) < ex["n_edges"]),
           "labels": torch.as_tensor(labels),
           "node_graph": torch.zeros(n, dtype=torch.int32)}
    if arch.id == "schnet":
        out["positions"] = torch.as_tensor(rng.standard_normal((n, 3), dtype=np.float32))
    return out


def _gnn(mesh, cell_name: str = "full_graph_sm", f64=GNN_ARCHS + MORE_GNN_ARCHS) -> dict:
    """Each GNN's step metrics in f32, and (for the archs in ``f64``) its
    loss, gradients and step metrics in f64, plain on this process and
    sharded over ``mesh`` (state by ``state_shardings``, the batch by
    ``input_shardings``, under the logical-axis rules), on the node cell
    cut to ``GNN_CELL`` or the molecule cell cut to ``MOLECULE_CELL``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.models import gnn
    from repro_torch.optimizer import adamw

    class F64Arch(base.GNNArch):
        """The GNN with f64 activations and parameters."""

        def cell_cfg(self, cell):
            return dataclasses.replace(super().cell_cfg(cell), dtype=torch.float64,
                                       param_dtype=torch.float64)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    extras = GNN_CELL if cell_name == "full_graph_sm" else MOLECULE_CELL
    out, held = {}, {}
    for arch_id in GNN_ARCHS + MORE_GNN_ARCHS:
        for dtype, kind in (("float32", base.GNNArch), ("float64", F64Arch)):
            if dtype == "float64" and arch_id not in f64:
                continue
            arch = kind(arch_id, configs.get(arch_id).reduced())
            cell = dataclasses.replace(arch.cells()[cell_name], extras=dict(extras))
            cfg = arch.cell_cfg(cell)
            batch = _gnn_batch(arch, cell)
            for key in ("feat", "positions"):  # schnet's atom types stay integers
                if key in batch and batch[key].is_floating_point():
                    batch[key] = batch[key].to(cfg.dtype)
            graphs = {"n_graphs": extras["n_graphs"]} if cfg.task == "graph_reg" else {}
            plain = gnn.init_params(cfg, SEED, device="cpu")
            model = copy.deepcopy(plain)
            placed = sh.place({"params": model, "opt": adamw.init(list(model.parameters()))},
                              arch.state_shardings(mesh, cell),
                              lambda t, ns: distribute_tensor(t.clone(), mesh, ns.placements))
            placed_batch = sh.place(dict(batch), arch.input_shardings(mesh, cell),
                                    lambda t, ns: distribute_tensor(t, mesh, ns.placements))
            res = {}
            for name, state, b in (
                    ("plain", {"params": plain, "opt": adamw.init(list(plain.parameters()))},
                     batch),
                    ("sharded", placed, placed_batch)):
                sharded = name == "sharded"
                rules = logical_axis_rules(mesh) if sharded else contextlib.nullcontext()
                implicit = implicit_replication() if sharded else contextlib.nullcontext()
                grads = []
                with rules, implicit:
                    if dtype == "float64":
                        # the zero positions GNNArch.step gives a batch without any
                        zeros = torch.zeros((b["feat"].shape[0], 3), dtype=cfg.dtype)
                        params = list(state["params"].parameters())
                        loss = gnn.loss_fn(cfg, state["params"],
                                           dict(b, positions=b.get("positions", zeros),
                                                **graphs))
                        grads = torch.autograd.grad(loss, params, allow_unused=True)
                    _, metrics = arch.step(cell)(state, b)
                read = {k: full(v) for k, v in metrics.items()}
                if sharded:
                    _record(held, mesh, f"{arch_id}/{dtype}",
                            {"state": state, "grads": grads, "metrics": metrics, "read": read})
                res[name] = dict(
                    grads=[None if g is None else full(g).detach().numpy() for g in grads],
                    step={k: float(v) for k, v in read.items()})
            out[arch_id, dtype] = res
    out["held"] = held
    return out


def _words(chi) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    from repro_torch.core import bitops

    return bitops.words_np(bitops.pack(chi.full_tensor() if isinstance(chi, DTensor) else chi))


def _q_sparse(mesh) -> dict:
    """One ``sparse`` sweep of the q_sparse cell (``DualsimArch.step``):
    chi's packed words from the plain operands and from the operands
    placed as ``state_shardings``' rules place them (edges sharded over
    every mesh axis, chi's columns over the non-pod axes)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.core import dualsim, soi, sparql
    from repro_torch.data import synth
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["q_sparse"]
    g = synth.random_graph(n_nodes=512, n_labels=2, n_edges=4096, seed=SEED)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g)
    ops = dualsim.make_sparse_operands(c, g, device="cpu")
    step = arch.step(cell)
    chi, _ = step(ops, {})
    placed = arch.place(ops, cell, mesh)
    with logical_axis_rules(mesh), implicit_replication():
        chi_sh, _ = step(placed, {})
        chi_bl, _ = step(arch.place(ops, cell, mesh, blocked=True), {})
    held = {}
    _record(held, mesh, "chi", {"sharded": chi_sh, "blocked": chi_bl})
    want = sh.named(mesh, tuple(ops.init.shape), arch.spec_for("init", cell, mesh))
    return dict(plain=_words(chi), sharded=_words(chi_sh), blocked=_words(chi_bl),
                init=str(placed.init.placements), want=str(want.placements), held=held,
                live=int(chi.sum()), n=g.n_nodes, v=int(chi.shape[0]))


def _q_partitioned(mesh) -> dict:
    """One sweep of the q_partitioned cell (``DualsimArch.step``) over 4
    destination blocks, plain and with the blocks sharded over every mesh
    axis (``state_shardings``' ``edge_src_b`` rule) and chi's columns with
    them."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.core import dualsim, soi, sparql
    from repro_torch.data import synth
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["q_partitioned"]
    g = synth.random_graph(n_nodes=500, n_labels=2, n_edges=4096, seed=SEED)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g)
    ops = dualsim.make_partitioned_operands(c, g, 4, device="cpu")
    step = arch.step(cell)
    chi, _ = step(ops, {})
    placed = arch.place(ops, cell, mesh)
    with logical_axis_rules(mesh), implicit_replication():
        chi_sh, _ = step(placed, {})
        chi_bl, _ = step(arch.place(ops, cell, mesh, blocked=True), {})
    held = {}
    _record(held, mesh, "chi", {"sharded": chi_sh, "blocked": chi_bl})
    want = sh.named(mesh, tuple(ops.init.shape), arch.spec_for("init", cell, mesh))
    return dict(plain=_words(chi), sharded=_words(chi_sh), blocked=_words(chi_bl),
                init=str(placed.init.placements), want=str(want.placements), held=held,
                live=int(chi.sum()), n=int(chi.shape[1]), v=int(chi.shape[0]))


def _q_parallel(mesh) -> dict:
    """A query-parallel ``sparse`` batch (``batched_soi`` of
    ``BATCH_QUERIES``) with ``batch16_sparse``'s placement and
    ``chi_spec``: one sweep through ``DualsimArch.step``, and the whole
    fixpoint in Gauss–Seidel and Jacobi order, plain and sharded."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.core import dualsim, soi, sparql
    from repro_torch.data import synth
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.engine import batcher

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["batch16_sparse"]
    g = synth.random_graph(n_nodes=500, n_labels=2, n_edges=4096, seed=SEED)
    parts = [soi.build_soi(sparql.parse(q)) for q in BATCH_QUERIES]
    c = soi.compile_soi(batcher.batched_soi(parts), g)
    ops = dualsim.make_sparse_operands(c, g, device="cpu")
    placed = arch.place(ops, cell, mesh)
    blocked = arch.place(ops, cell, mesh, blocked=True)
    spec = arch.spec_for("init", cell, mesh)
    runs = {"sweep": lambda o: arch.step(cell)(o, {}),
            "gs": lambda o: dualsim.solve_sparse(o, chi_spec=spec),
            "jacobi": lambda o: dualsim.solve_sparse(o, mode="jacobi_packed", chi_spec=spec)}
    out = {"v": int(ops.init.shape[0]), "n": g.n_nodes,
           "rows": str(placed.init.placements),
           "want": str(sh.named(mesh, tuple(ops.init.shape), spec).placements), "held": {}}
    for name, run in runs.items():
        chi, it = run(ops)
        with logical_axis_rules(mesh), implicit_replication():
            chi_sh, it_sh = run(placed)
            chi_bl, it_bl = run(blocked)
        _record(out["held"], mesh, name,
                {"sharded": chi_sh, "blocked": chi_bl, "sweeps": (it_sh, it_bl)})
        out[name] = dict(plain=_words(chi), sharded=_words(chi_sh), sweeps=(it, it_sh),
                         live=int(chi.sum()), rows=str(chi_sh.placements),
                         blocked=_words(chi_bl), blocked_sweeps=it_bl,
                         blocked_rows=str(chi_bl.placements))
    return out


def _no_chi_spec(mesh) -> str:
    """The error of a ``sparse`` sweep over DTensor operands without
    ``chi_spec``."""
    from repro_torch import configs
    from repro_torch.core import dualsim, soi, sparql
    from repro_torch.data import synth

    arch = configs.get("dualsim-lubm")
    g = synth.random_graph(n_nodes=64, n_labels=2, n_edges=256, seed=SEED)
    ops = dualsim.make_sparse_operands(soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g),
                                       g, device="cpu")
    try:
        dualsim.solve_sparse(arch.place(ops, arch.cells()["q_sparse"], mesh), max_sweeps=1)
    except ValueError as e:
        return str(e)
    return ""


def _lm(mesh) -> dict:
    """The dense LM's and the MoE LM's ``reduced()`` f32 train step
    (``LMArch.step``, one microbatch of ``LM_BATCH x LM_SEQ``) and the
    gradients of ``loss_fn``, on the plain state and on the state placed by
    ``state_shardings``, both under the logical-axis rules; every call of
    ``route`` recorded, and every rank's records gathered."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.distributed import ctx
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.models import transformer as tr
    from repro_torch.optimizer import adamw

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    out, held = {}, {}
    route = tr.route
    for arch_id in LM_ARCHS:
        cfg = configs.get(arch_id).reduced()
        arch = base.LMArch(cfg)
        cell = base.Cell("train", "train", batch=LM_BATCH, seq=LM_SEQ)
        rng = np.random.default_rng(SEED)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ),
                                                 dtype=np.int32))
                 for k in ("tokens", "labels")}
        plain = tr.init_params(cfg, SEED, device="cpu")
        model = copy.deepcopy(plain)
        placed = sh.place({"params": model, "opt": adamw.init(list(model.parameters()))},
                          arch.state_shardings(mesh, cell),
                          lambda t, ns: distribute_tensor(t.clone(), mesh, ns.placements))
        placed_batch = sh.place(dict(batch), arch.input_shardings(mesh, cell),
                                lambda t, ns: distribute_tensor(t, mesh, ns.placements))
        res = {}
        for name, state, b in (
                ("plain", {"params": plain, "opt": adamw.init(list(plain.parameters()))},
                 batch),
                ("sharded", placed, placed_batch)):
            calls = []

            def recorded(cfg_, router, xg, calls=calls):
                probs, disp = route(cfg_, router, xg)
                calls.append({k: getattr(disp, k).detach().numpy().copy()
                              for k in ("expert", "token", "pos", "counts")})
                return probs, disp

            sharded = name == "sharded"
            implicit = implicit_replication() if sharded else contextlib.nullcontext()
            tr.route = recorded
            try:
                with logical_axis_rules(mesh), implicit:
                    params = list(state["params"].parameters())
                    grads = torch.autograd.grad(tr.loss_fn(cfg, state["params"], b), params)
                    _, metrics = arch.step(cell)(state, b)
                    groups = ctx.shard_index(mesh, (ctx.logical_spec((LM_BATCH * LM_SEQ,),
                                                                      "batch") or P(None))[0])
            finally:
                tr.route = route
            read = {k: full(v) for k, v in metrics.items()}
            if sharded:
                _record(held, mesh, arch_id,
                        {"state": state, "grads": grads, "metrics": metrics, "read": read})
                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, (groups, calls))
                calls = every
            res[name] = dict(grads=[full(g).detach().numpy() for g in grads],
                             step={k: float(v) for k, v in read.items()}, dispatch=calls)
        out[arch_id] = res
    out["held"] = held
    return out


def _lm_serve(mesh, archs, batch: int) -> dict:
    """Each LM's ``reduced()`` f32 ``prefill_step`` on ``batch x LM_SEQ``
    tokens, then ``DECODE_STEPS`` ``decode_step``s, on the plain parameters
    and on those placed by ``LMArch.state_shardings`` (the tokens by
    ``input_shardings``), both under the logical-axis rules (so the MoE
    blocks its tokens into the same groups): after each step the logits,
    the cache and ``pos`` read back whole, and the cache's placements
    beside those ``lm_cache_spec`` gives."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.models import transformer as tr

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    out, held = {}, {}
    for arch_id in archs:
        cfg = configs.get(arch_id).reduced()
        arch = base.LMArch(cfg)
        cells = [base.Cell("prefill", "prefill", batch=batch, seq=LM_SEQ)]
        cells += [base.Cell("decode", "decode", batch=batch, seq=LM_SEQ)] * DECODE_STEPS
        rng = np.random.default_rng(SEED)
        tokens = [torch.as_tensor(rng.integers(0, cfg.vocab, (batch, c.seq if c.kind == "prefill"
                                                               else 1), dtype=np.int32))
                  for c in cells]
        plain = tr.init_params(cfg, SEED, device="cpu")
        placed = sh.place(copy.deepcopy(plain), arch.state_shardings(mesh, cells[1])["params"],
                          lambda t, ns: distribute_tensor(t.clone(), mesh, ns.placements))
        s_cache = min(LM_SEQ, cfg.sliding_window or LM_SEQ)
        specs = sh.lm_cache_spec(mesh, cfg, batch, s_cache)
        shapes = {"k": (cfg.n_layers, batch, s_cache, cfg.n_kv_heads, cfg.head_dim),
                  "pos": (batch,)}
        res = {"want": {k: str(sh.named(mesh, shapes["pos" if k == "pos" else "k"],
                                        specs[k]).placements) for k in ("k", "v", "pos")}}
        for name, params in (("plain", plain), ("sharded", placed)):
            sharded = name == "sharded"
            implicit = implicit_replication() if sharded else contextlib.nullcontext()
            steps, cache = [], None
            with logical_axis_rules(mesh), implicit:
                for cell, t in zip(cells, tokens):
                    if sharded:
                        t = sh.place({"tokens": t}, arch.input_shardings(mesh, cell),
                                     lambda x, ns: distribute_tensor(x, mesh, ns.placements))
                        t = t["tokens"]
                    if cell.kind == "prefill":
                        logits, cache = tr.prefill_step(cfg, params, t)
                    else:
                        logits, cache = tr.decode_step(cfg, params, cache, t)
                    if sharded:
                        _record(held, mesh, f"{arch_id}/{len(steps)}",
                                {"logits": logits, "cache": cache})
                    steps.append(dict(
                        logits=full(logits), **{k: full(cache[k]) for k in ("k", "v", "pos")},
                        placements={k: str(getattr(cache[k], "placements", None))
                                    for k in ("k", "v", "pos")}))
            res[name] = steps
        out[arch_id] = res
    out["held"] = held
    return out


def _block_dense(mesh) -> dict:
    """One sweep of the block_dense cell (``DualsimArch.step``, a dense f32
    product a operator), plain and over the operands ``DualsimArch.place``
    puts on the mesh (chi's columns over ``model``, the adjacency's rows
    over ``data`` and its columns over ``model``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.core import dualsim, soi, sparql
    from repro_torch.data import synth
    from repro_torch.distributed.ctx import logical_axis_rules

    from repro_torch.distributed import shard as sh

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["block_dense"]
    g = synth.random_graph(n_nodes=256, n_labels=2, n_edges=1024, seed=SEED)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g)
    ops = dualsim.make_dense_operands(c, g, device="cpu")
    step = arch.step(cell)
    chi, _ = step(ops, {})
    placed = arch.place(ops, cell, mesh)
    with logical_axis_rules(mesh), implicit_replication():
        chi_sh, _ = step(placed, {})
    held = {}
    _record(held, mesh, "chi", {"sharded": chi_sh})
    want = sh.named(mesh, tuple(ops.adj_dense.shape), arch.spec_for("adj_dense", cell, mesh))
    return dict(plain=_words(chi), sharded=_words(chi_sh), live=int(chi.sum()),
                n=g.n_nodes, v=int(chi.shape[0]), adj=str(placed.adj_dense.placements),
                want=str(want.placements), held=held)


def _recsys(mesh) -> dict:
    """dcn-v2's ``reduced()`` config with ``RECSYS_VOCAB`` (so every mesh
    here splits the table's rows and ``ctx.lookup`` runs shard-local): one
    f32 train step and the gradients of ``loss_fn``, plain and sharded."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.models import recsys
    from repro_torch.optimizer import adamw

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    cfg = dataclasses.replace(configs.get("dcn-v2").reduced(), vocab_sizes=RECSYS_VOCAB)
    arch = base.RecsysArch(cfg)
    cell = base.Cell("train_batch", "train", batch=RECSYS_BATCH)
    rng = np.random.default_rng(SEED)
    batch = _recsys_inputs(cfg, RECSYS_BATCH, rng)
    batch["labels"] = torch.as_tensor(rng.integers(0, 2, RECSYS_BATCH).astype(np.float32))
    plain = recsys.init_params(cfg, SEED, device="cpu")
    model = copy.deepcopy(plain)
    state_sh = arch.state_shardings(mesh, cell)
    placed = sh.place({"params": model, "opt": adamw.init(list(model.parameters()))},
                      state_sh, lambda t, ns: distribute_tensor(t.clone(), mesh, ns.placements))
    placed_batch = sh.place(dict(batch), arch.input_shardings(mesh, cell),
                            lambda t, ns: distribute_tensor(t, mesh, ns.placements))
    res = {"table": str(placed["params"].table.placements), "held": {}}
    for name, state, b in (
            ("plain", {"params": plain, "opt": adamw.init(list(plain.parameters()))}, batch),
            ("sharded", placed, placed_batch)):
        implicit = implicit_replication() if name == "sharded" else contextlib.nullcontext()
        with logical_axis_rules(mesh), implicit:
            params = list(state["params"].parameters())
            grads = torch.autograd.grad(recsys.loss_fn(cfg, state["params"], b), params)
            _, metrics = arch.step(cell)(state, b)
        read = {k: full(v) for k, v in metrics.items()}
        if name == "sharded":
            _record(res["held"], mesh, "train",
                    {"state": state, "grads": grads, "metrics": metrics, "read": read})
        res[name] = dict(grads=[full(g).detach().numpy() for g in grads],
                         step={k: float(v) for k, v in read.items()})
    return res


def _recsys_inputs(cfg, batch: int, rng) -> dict:
    return {"dense": torch.as_tensor(rng.standard_normal((batch, cfg.n_dense),
                                                         dtype=np.float32)),
            "sparse": torch.as_tensor(np.stack([rng.integers(0, v, batch)
                                                for v in cfg.vocab_sizes], 1).astype(np.int32))}


def _candidates(cfg, params, batch: dict, rng) -> torch.Tensor:
    """``N_CANDIDATES`` random item vectors, each moved along the query's
    own vector so that its score is a distinct multiple, from ``N / 2`` to
    ``3 N / 2``, of a spacing no rounding can cross: no two scores tie, the
    top 100 are one set in one order, and no score sits near zero, where a
    relative tolerance would measure rounding alone."""
    from repro_torch.models import recsys

    with torch.no_grad():
        q = recsys._trunk(cfg, params, batch)[0].double().numpy()
    cand = rng.standard_normal((N_CANDIDATES, q.shape[0]))
    target = (rng.permutation(N_CANDIDATES) + N_CANDIDATES / 2) * 1e-2 * np.linalg.norm(q)
    cand += np.outer(target - cand @ q, q) / (q @ q)
    return torch.as_tensor(cand.astype(np.float32))


def _recsys_serve(mesh) -> dict:
    """dcn-v2's serving cells on the ``reduced()`` config with
    ``RECSYS_VOCAB``: ``serve_p99`` and ``serve_bulk`` (``RecsysArch.step``'s
    sigmoid, the batch cut to ``SERVE_BATCHES``) and ``retrieval_cand``
    (``N_CANDIDATES`` candidates over ``(data, model)``, the scores and the
    top 100), plain and on the state and inputs placed by the cell's
    shardings; the outputs read back whole, and their placements beside
    the batch's."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.models import recsys

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    cfg = dataclasses.replace(configs.get("dcn-v2").reduced(), vocab_sizes=RECSYS_VOCAB)
    arch = base.RecsysArch(cfg)
    plain = recsys.init_params(cfg, SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    out, held = {}, {}
    for name, cell in arch.cells().items():
        if cell.kind == "serve":
            cell = dataclasses.replace(cell, batch=SERVE_BATCHES[name])
        elif cell.kind == "retrieval":
            cell = dataclasses.replace(cell, extras=dict(cell.extras,
                                                         n_candidates=N_CANDIDATES))
        else:
            continue
        batch = _recsys_inputs(cfg, cell.batch, rng)
        if cell.kind == "retrieval":
            batch["candidates"] = _candidates(cfg, plain, batch, rng)
        placed = sh.place({"params": copy.deepcopy(plain)}, arch.state_shardings(mesh, cell),
                          lambda t, ns: distribute_tensor(t.clone(), mesh, ns.placements))
        placed_batch = sh.place(dict(batch), arch.input_shardings(mesh, cell),
                                lambda t, ns: distribute_tensor(t, mesh, ns.placements))
        step = arch.step(cell)
        with torch.no_grad(), logical_axis_rules(mesh):
            want = step({"params": plain}, batch)
            with implicit_replication():
                got = step(placed, placed_batch)
        want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
        _record(held, mesh, name, got)
        out[name] = dict(plain=[full(t) for t in want], sharded=[full(t) for t in got],
                         placements=[str(t.placements) for t in got],
                         batch=str(placed_batch["dense"].placements))
    out["held"] = held
    return out


def _with_model(mesh):
    """``mesh``, or on the 1-D ``(data,)`` mesh the same ranks as a ``(1,
    n)`` ``(data, model)`` mesh: the LM and recsys rules name both axes, as
    every production mesh has them."""
    from torch.distributed.device_mesh import init_device_mesh

    if "model" in mesh.mesh_dim_names:
        return mesh
    return init_device_mesh("cpu", (1, mesh.size()), mesh_dim_names=("data", "model"))


def _cases(world: int) -> dict:
    cases = {
        "random_amax": lambda m: _seg_reduce(m, _random_case(world), "amax"),
        "random_amin": lambda m: _seg_reduce(m, _random_case(world), "amin"),
        "gnn": _gnn,
        "molecule": lambda m: _gnn(m, "molecule"),
        "q_sparse": _q_sparse,
        "q_partitioned": _q_partitioned,
        "lm": lambda m: _lm(_with_model(m)),
        "lm_serve": lambda m: _lm_serve(_with_model(m), SERVE_ARCHS, LM_BATCH),
        "recsys": lambda m: _recsys(_with_model(m)),
        "recsys_serve": lambda m: _recsys_serve(_with_model(m)),
        "block_dense": _block_dense,
    }
    if world == 8:
        cases["gnn"] = lambda m: _gnn(m, f64=F64_ON_8["gnn"])
        cases["molecule"] = lambda m: _gnn(m, "molecule", F64_ON_8["molecule"])
    if world >= 4:
        cases["q_parallel"] = _q_parallel
        cases["lm_serve_one"] = lambda m: _lm_serve(m, SERVE_ONE_ARCHS, 1)
    if world == 2:
        cases.update({
            "no_chi_spec": _no_chi_spec,
            "example": lambda m: _seg_reduce(m, EXAMPLE, "amax"),
            "ties": lambda m: _seg_reduce(m, TIES, "amax"),
            "amin": lambda m: _seg_reduce(m, dict(TIES, vals=[1.0, 7.0, 1.0, 1.0]), "amin"),
            "empty": lambda m: _seg_reduce(m, EMPTY, "amax"),
        })
    return cases


def _rank(rank: int, world: int, rdv: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        shape, names = MESHES[world]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        results, held = {}, {}
        for name, case in _cases(world).items():
            results[name] = case(mesh)
            if isinstance(results[name], dict):
                held.update({(name, what): v
                             for what, v in results[name].pop("held", {}).items()})
        # every rank's records, for the replica check
        every = [None] * world
        dist.all_gather_object(every, held)
        results["replicas"] = every
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _spawn(tmp: str, world: int) -> dict:
    import torch.multiprocessing as mp

    out = os.path.join(tmp, f"results_{world}.pt")
    mp.spawn(_rank, args=(world, os.path.join(tmp, f"rdv_{world}"), out), nprocs=world)
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world size: {case: rank 0's results}}, one gloo group a world size."""
    tmp = str(tmp_path_factory.mktemp("multirank"))
    return {world: _spawn(tmp, world) for world in (2, 4)}


# --------------------------------------------------------------------- #
# the plain versions, on this process, and the checks every group makes
# --------------------------------------------------------------------- #
def _scatter_reduce(case: dict, reduce: str) -> dict:
    vals = torch.as_tensor(np.asarray(case["vals"], np.float32)).requires_grad_()
    idx = torch.as_tensor(np.asarray(case["idx"], np.int64))
    ix = idx.reshape(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
    init = float("-inf") if reduce == "amax" else float("inf")
    out = torch.full((case["n"], *vals.shape[1:]), init).scatter_reduce(
        0, ix, vals, reduce, include_self=True)
    weight = case.get("weight", np.ones(tuple(out.shape), np.float32))
    w = torch.as_tensor(np.asarray(weight, np.float32))
    (torch.where(torch.isfinite(out), out, torch.zeros_like(out)) * w).sum().backward()
    return dict(out=out.detach().numpy(), grad=vals.grad.numpy())


def _check_segment_extreme(got: dict, world: int, reduce: str) -> None:
    """The random case's values and gradient equal ``scatter_reduce``'s and
    the JAX package's ``jax.grad`` of ``segment_max`` / ``segment_min``."""
    import jax
    import jax.numpy as jnp

    case = _random_case(world)
    want = _scatter_reduce(case, reduce)
    np.testing.assert_array_equal(got["out"], want["out"])
    np.testing.assert_array_equal(got["grad"], want["grad"])
    seg = jax.ops.segment_max if reduce == "amax" else jax.ops.segment_min

    def loss(v):
        out = seg(v, jnp.asarray(case["idx"]), num_segments=case["n"])
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * case["weight"])

    jax_grad = np.asarray(jax.grad(loss)(jnp.asarray(case["vals"])))
    assert np.any((jax_grad != 0) & (jax_grad != np.round(jax_grad)))  # a tie was split
    np.testing.assert_allclose(got["grad"], jax_grad, rtol=1e-5, atol=0)


def _check_gnn(res: dict, dtype: str, norm_rtol: float) -> None:
    """The step's loss within rtol 1e-5 and its gradient norm within
    ``norm_rtol``; in f64 every gradient within rtol 1e-12, atol 1e-14."""
    plain, sharded = res["plain"], res["sharded"]
    np.testing.assert_allclose(sharded["step"]["loss"], plain["step"]["loss"], rtol=1e-5,
                               atol=0, err_msg="loss")
    np.testing.assert_allclose(sharded["step"]["grad_norm"], plain["step"]["grad_norm"],
                               rtol=norm_rtol, atol=0, err_msg="grad_norm")
    assert len(sharded["grads"]) == len(plain["grads"])
    assert (len(plain["grads"]) > 0) == (dtype == "float64")
    for k, (a, b) in enumerate(zip(sharded["grads"], plain["grads"])):
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14, err_msg=f"gradient {k}")


def _check_words(got: dict, key: str = "sharded") -> None:
    assert 0 < got["live"] < got["v"] * got["n"]  # the sweep removed some, not all
    np.testing.assert_array_equal(got[key], got["plain"])


def _check_q_parallel(got: dict, run: str) -> None:
    """The query-parallel batch, flat and blocked: chi bit for bit, the
    sweeps equal, the operands placed as ``spec_for`` says, and the
    result's rows still split over ``data`` (its words whole: 500 nodes do
    not fill the words' shards, so ``unpack`` gathers them)."""
    assert got["v"] == 8 and "Shard(dim=0)" in got["rows"]
    assert got["rows"] == got["want"]
    res = got[run]
    assert 0 < res["live"] < got["v"] * got["n"]
    assert res["sweeps"][0] == res["sweeps"][1] == res["blocked_sweeps"]
    assert "Shard(dim=0)" in res["rows"] and res["rows"] == res["blocked_rows"]
    np.testing.assert_array_equal(res["sharded"], res["plain"])
    np.testing.assert_array_equal(res["blocked"], res["plain"])


def _check_grads(sharded: dict, plain: dict) -> None:
    """Loss and gradient norm within rtol 1e-5, every gradient within rtol
    1e-4 (atol 1e-4 times its largest magnitude)."""
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(sharded["step"][key], plain["step"][key], rtol=1e-5,
                                   atol=0, err_msg=key)
    assert len(sharded["grads"]) == len(plain["grads"]) > 0
    for k, (a, b) in enumerate(zip(sharded["grads"], plain["grads"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"gradient {k}")


def _check_dispatch(res: dict) -> None:
    """Every rank routes the groups its batch shard holds (replicated
    across the expert split) exactly as the plain step routes them."""
    plain = res["plain"]["dispatch"]
    assert len(plain) > 0
    g_total = plain[0]["expert"].shape[0]
    for rank, ((g, n_g), calls) in enumerate(res["sharded"]["dispatch"]):
        assert len(calls) == len(plain), rank
        per = g_total // n_g
        for i, (got, want) in enumerate(zip(calls, plain)):
            for key in ("expert", "token", "pos", "counts"):
                np.testing.assert_array_equal(got[key], want[key][g * per:(g + 1) * per],
                                              err_msg=f"rank {rank} call {i} {key}")


def _check_serving(res: dict) -> None:
    """Every step's logits and cache within rtol 1e-5 (atol 1e-5 times the
    largest magnitude), ``pos`` exactly, the cache in ``lm_cache_spec``'s
    placement after every step."""
    assert len(res["plain"]) == len(res["sharded"]) == 1 + DECODE_STEPS
    for i, (plain, sharded) in enumerate(zip(res["plain"], res["sharded"])):
        assert sharded["placements"] == res["want"], i
        np.testing.assert_array_equal(sharded["pos"], plain["pos"], err_msg=f"step {i}")
        for key in ("logits", "k", "v"):
            want = plain[key]
            np.testing.assert_allclose(sharded[key], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"step {i} {key}")


def _check_recsys_serve(res: dict, cell: str) -> None:
    """The sigmoid outputs, or the retrieval scores, within f32 rtol 1e-5;
    the top 100 equal exactly, and no two scores tied."""
    got = res[cell]
    np.testing.assert_allclose(got["sharded"][0], got["plain"][0], rtol=1e-5, atol=0)
    if cell == "retrieval_cand":
        scores = np.sort(got["plain"][0][0])
        assert np.diff(scores).min() > 1e-3 * scores.max() and scores.min() > 0  # no tie
        np.testing.assert_array_equal(got["sharded"][1], got["plain"][1])
        assert got["plain"][1].shape == (1, 100)


def _check_replicas(replicas: list, case: str) -> None:
    """Replica agreement, bit for bit: every two ranks at the same
    coordinate on each mesh dim that splits a tensor (``Shard`` or
    ``Partial``) hold equal local tensors, so ranks that differ only on a
    dim where it is replicated hold one value; and every scalar metric, as
    each rank reads it whole, is split by no dim, so every rank's is equal."""
    whats = sorted(w for c, w in replicas[0] if c == case)
    assert whats, case
    for what in whats:
        held = [every[case, what] for every in replicas]
        paths = held[0][1].keys()
        assert paths
        for path in paths:
            split = held[0][1][path][0]
            if path.startswith("read/"):
                assert split == (), (what, path)
            first = {}
            for rank, (coord, leaves) in enumerate(held):
                assert leaves.keys() == paths, (what, rank)
                s, local = leaves[path]
                assert s == split, (what, path, rank)
                at = tuple(coord[k] for k in split)
                if at not in first:
                    first[at] = (rank, local)
                    continue
                r0, want = first[at]
                assert local.dtype == want.dtype and local.shape == want.shape, (what, path)
                assert local.tobytes() == want.tobytes(), (
                    f"{what} {path}: ranks {r0} and {rank} differ at mesh coordinate {at} "
                    f"on the dims {split} that split it")


def _replica_cases(world: int) -> list[str]:
    """The cases whose ranks record what they hold (every one that runs a
    step to its end)."""
    return [c for c in _cases(world) if c != "no_chi_spec"]


def test_segment_max_gradient_crosses_shards_roadmap_example(groups):
    got = groups[2]["example"]
    np.testing.assert_array_equal(got["out"], [3.0, 5.0])
    np.testing.assert_array_equal(got["grad"], [0.0, 1.0, 1.0, 0.0])
    want = _scatter_reduce(EXAMPLE, "amax")
    np.testing.assert_array_equal(got["grad"], want["grad"])


@pytest.mark.parametrize("name,reduce", [("ties", "amax"), ("amin", "amin")])
def test_segment_extreme_ties_across_shards_split_evenly(groups, name, reduce):
    case = TIES if name == "ties" else dict(TIES, vals=[1.0, 7.0, 1.0, 1.0])
    got, want = groups[2][name], _scatter_reduce(case, reduce)
    np.testing.assert_array_equal(got["out"], want["out"])
    np.testing.assert_array_equal(got["grad"], want["grad"])
    # three tied edges, two on the second shard: a third of weight 2 each
    np.testing.assert_allclose(got["grad"], [2 / 3, 3.0, 2 / 3, 2 / 3], rtol=1e-6)


def test_segment_max_empty_segment_keeps_identity(groups):
    got, want = groups[2]["empty"], _scatter_reduce(EMPTY, "amax")
    assert got["out"][2] == float("-inf")
    np.testing.assert_array_equal(got["out"], want["out"])
    np.testing.assert_array_equal(got["grad"], want["grad"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("reduce", ["amax", "amin"])
def test_segment_extreme_gradient_matches_jax(groups, world, reduce):
    """Random values with ties within and across shards, two empty
    segments: the gradient equals ``scatter_reduce``'s and the JAX
    package's ``jax.grad`` of ``segment_max`` / ``segment_min``."""
    _check_segment_extreme(groups[world][f"random_{reduce}"], world, reduce)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_sharded_step_equals_plain_step(groups, world, arch_id, dtype):
    _check_gnn(groups[world]["gnn"][arch_id, dtype], dtype,
               1e-5 if dtype == "float32" else 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", MORE_GNN_ARCHS)
def test_more_gnn_sharded_steps_equal_plain_steps(groups, world, arch_id, dtype):
    _check_gnn(groups[world]["gnn"][arch_id, dtype], dtype, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", GNN_ARCHS + MORE_GNN_ARCHS)
def test_gnn_molecule_sharded_step_equals_plain_step(groups, world, arch_id, dtype):
    """The molecule cell's graph readout (``graph_reg`` over ``node_graph``,
    the nodes split as the edges' rules leave them): loss and gradient
    norm within f32 rtol 1e-5, the f64 gradients as the node cell's."""
    _check_gnn(groups[world]["molecule"][arch_id, dtype], dtype, 1e-5)


def test_q_sparse_sweep_sharded_equals_one_rank(groups):
    _check_words(groups[2]["q_sparse"])


def test_q_sparse_sweep_on_the_2x2_mesh_equals_one_rank(groups):
    """Chi's words split over both mesh dims (the edges too)."""
    _check_words(groups[4]["q_sparse"])


@pytest.mark.parametrize("world", [2, 4])
def test_q_partitioned_sweep_sharded_equals_one_rank(groups, world):
    _check_words(groups[world]["q_partitioned"])


@pytest.mark.parametrize("run", ["sweep", "gs", "jacobi"])
def test_query_parallel_sparse_equals_one_rank(groups, run):
    """Two queries' variables over ``data`` (the second query's split
    across the two row shards), words over ``model``, 500 nodes (16 words,
    not a multiple of the node shards' bits): chi bit for bit and the
    sweeps equal, the result's rows still split over ``data``."""
    _check_q_parallel(groups[4]["q_parallel"], run)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cell", ["q_sparse", "q_partitioned"])
def test_blocked_sweep_sharded_equals_one_rank(groups, world, cell):
    """The same sweeps over each shard's edges in the blocked layout (a
    card's, here through the kernel wrapper's plain version): chi bit for
    bit, chi's start placed as ``spec_for`` says."""
    got = groups[world][cell]
    assert got["init"] == got["want"]
    _check_words(got, "blocked")


def test_sparse_sweep_over_dtensors_needs_chi_spec(groups):
    assert "chi_spec" in groups[2]["no_chi_spec"]


@pytest.mark.parametrize("run", ["sweep", "gs", "jacobi"])
def test_query_parallel_blocked_sparse_equals_one_rank(groups, run):
    """The query-parallel batch with each edge shard in the blocked layout:
    chi bit for bit, the sweeps equal, the rows split over ``data``."""
    res = groups[4]["q_parallel"][run]
    assert 0 < res["live"]
    assert res["blocked_sweeps"] == res["sweeps"][0]
    assert "Shard(dim=0)" in res["blocked_rows"]
    np.testing.assert_array_equal(res["blocked"], res["plain"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_sharded_step_equals_plain_step(groups, world, arch_id):
    res = groups[world]["lm"][arch_id]
    _check_grads(res["sharded"], res["plain"])


@pytest.mark.parametrize("world", [2, 4])
def test_moe_dispatch_sharded_equals_plain(groups, world):
    """Every rank routes the groups its batch shard holds (replicated
    across the expert split) exactly as the plain step routes them."""
    _check_dispatch(groups[world]["lm"]["olmoe-1b-7b"])


@pytest.mark.parametrize("world", [2, 4])
def test_recsys_sharded_step_equals_plain_step(groups, world):
    res = groups[world]["recsys"]
    assert "Shard(dim=0)" in res["table"]  # the lookup is the sharded one
    _check_grads(res["sharded"], res["plain"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cell", ["serve_p99", "serve_bulk", "retrieval_cand"])
def test_recsys_serving_sharded_equals_plain(groups, world, cell):
    """dcn-v2's serving cells on the state and inputs their shardings
    place: the sigmoid outputs, or the scores, within rtol 1e-5 and the
    top 100 exactly.  On the 2 x 2 mesh the batch goes over ``data`` and
    the outputs come back split over ``model`` too (the head's product
    over the MLP's ``model``-split columns is reduce-scattered); on the
    ``(1, 2)`` mesh the batch and the outputs are whole.  The scores come
    back split over the candidates' ``(data, model)``, the top 100 whole."""
    res = groups[world]["recsys_serve"]
    _check_recsys_serve(res, cell)
    rep = "(Replicate(), Replicate())"
    if cell == "retrieval_cand":
        assert res[cell]["placements"] == ["(Shard(dim=1), Shard(dim=1))", rep]
    elif world == 2:
        assert res[cell]["batch"] == rep and res[cell]["placements"] == [rep]
    else:
        assert res[cell]["batch"] == "(Shard(dim=0), Replicate())"
        assert res[cell]["placements"] == ["(Shard(dim=0), Shard(dim=0))"]


def _serve_cases(groups, world, case, arch_id):
    res = groups[world][case][arch_id]
    assert len(res["plain"]) == len(res["sharded"]) == 1 + DECODE_STEPS
    return res


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", SERVE_ARCHS)
def test_lm_sharded_serving_equals_plain_serving(groups, world, arch_id):
    """Prefill and three decode steps on state placed as the serving cells
    place it: the logits and the cache of every step as the plain steps',
    ``pos`` exactly, and the cache in ``lm_cache_spec``'s placement after
    prefill and after every step (batch over ``data``, sequence over
    ``model``)."""
    res = _serve_cases(groups, world, "lm_serve", arch_id)
    assert "Shard(dim=2)" in res["want"]["k"]
    _check_serving(res)


@pytest.mark.parametrize("arch_id", SERVE_ONE_ARCHS)
def test_lm_sharded_serving_batch_one_splits_the_sequence_four_ways(groups, arch_id):
    """Batch 1 on the 2 x 2 mesh: the cache's sequence split over ``(data,
    model)`` into 4 shards (mixtral's 8-position window, 2 a shard), each
    decode step's roll crossing both mesh dims; held as above."""
    res = _serve_cases(groups, 4, "lm_serve_one", arch_id)
    assert res["want"]["k"] == "(Shard(dim=2), Shard(dim=2))"
    assert res["want"]["pos"] == "(Replicate(), Replicate())"
    _check_serving(res)


@pytest.mark.parametrize("world", [2, 4])
def test_block_dense_sweep_sharded_equals_one_rank(groups, world):
    """The dense sweep over ``DualsimArch.place``'s operands: chi bit for
    bit (the adjacency's rows over ``data``, and on the 2 x 2 mesh its
    columns and chi's over ``model``)."""
    got = groups[world]["block_dense"]
    assert got["adj"] == ("(Shard(dim=1),)" if world == 2 else "(Shard(dim=1), Shard(dim=2))")
    assert got["adj"] == got["want"]
    _check_words(got)


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4) for c in _replica_cases(w)])
def test_replicas_agree_bit_for_bit(groups, world, case):
    """After each case every rank's local shard of each parameter, each
    optimizer moment, each gradient and each output equals that of every
    rank at its coordinate on the mesh dims that split it, and every rank
    reads the same scalar metrics."""
    _check_replicas(groups[world]["replicas"], case)
