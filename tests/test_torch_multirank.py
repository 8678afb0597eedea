"""Sharded paths of the port on a real multi-rank gloo group, held against
their plain versions on one process.

The production dry-run traces every sharded step over a fake process group
that moves no data, so only a group whose ranks exchange real values shows
whether a sharded step computes what the plain step computes.  Each world
size below spawns one gloo group for this module
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous in a temporary
directory, one thread a rank so that the suite's other workers keep their
cores); every case of that world size runs in the group in turn, and rank 0
hands the results back through a file.  Two ranks form a 1-D ``(data,)``
mesh (a ``(1, 2)`` ``(data, model)`` mesh for the LM and recsys cases,
whose rules name both axes); four ranks the 2 x 2 ``(data, model)`` mesh.

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
  ``DualsimArch.place`` puts on the mesh: chi bit for bit.
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
    return dict(out=out.full_tensor().detach().numpy(), grad=v.grad.full_tensor().numpy())


def _gnn_batch(arch, cell) -> dict:
    """A batch at the cell's padded shapes: random edges among the real
    nodes, the padding masked; labels -1 on padded nodes."""
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


def _gnn(mesh) -> dict:
    """Each GNN's step metrics in f32, and its loss, gradients and step
    metrics in f64, plain on this process and sharded over ``mesh`` (state
    by ``state_shardings``, the batch by ``input_shardings``, under the
    logical-axis rules)."""
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

    out = {}
    for arch_id in GNN_ARCHS + MORE_GNN_ARCHS:
        for dtype, kind in (("float32", base.GNNArch), ("float64", F64Arch)):
            arch = kind(arch_id, configs.get(arch_id).reduced())
            cell = dataclasses.replace(arch.cells()["full_graph_sm"], extras=dict(GNN_CELL))
            cfg = arch.cell_cfg(cell)
            batch = _gnn_batch(arch, cell)
            batch["feat"] = batch["feat"].to(cfg.dtype)
            if "positions" in batch:
                batch["positions"] = batch["positions"].to(cfg.dtype)
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
                                           dict(b, positions=b.get("positions", zeros)))
                        grads = torch.autograd.grad(loss, params, allow_unused=True)
                    _, metrics = arch.step(cell)(state, b)
                res[name] = dict(
                    grads=[None if g is None else full(g).detach().numpy() for g in grads],
                    step={k: float(full(v)) for k, v in metrics.items()})
            out[arch_id, dtype] = res
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
    from repro_torch.distributed.ctx import logical_axis_rules

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["q_sparse"]
    g = synth.random_graph(n_nodes=512, n_labels=2, n_edges=4096, seed=SEED)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g)
    ops = dualsim.make_sparse_operands(c, g, device="cpu")
    step = arch.step(cell)
    chi, _ = step(ops, {})
    with logical_axis_rules(mesh), implicit_replication():
        chi_sh, _ = step(arch.place(ops, cell, mesh), {})
        chi_bl, _ = step(arch.place(ops, cell, mesh, blocked=True), {})
    return dict(plain=_words(chi), sharded=_words(chi_sh), blocked=_words(chi_bl),
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
    from repro_torch.distributed.ctx import logical_axis_rules

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["q_partitioned"]
    g = synth.random_graph(n_nodes=500, n_labels=2, n_edges=4096, seed=SEED)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g)
    ops = dualsim.make_partitioned_operands(c, g, 4, device="cpu")
    step = arch.step(cell)
    chi, _ = step(ops, {})
    with logical_axis_rules(mesh), implicit_replication():
        chi_sh, _ = step(arch.place(ops, cell, mesh), {})
        chi_bl, _ = step(arch.place(ops, cell, mesh, blocked=True), {})
    return dict(plain=_words(chi), sharded=_words(chi_sh), blocked=_words(chi_bl),
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
           "rows": str(placed.init.placements)}
    for name, run in runs.items():
        chi, it = run(ops)
        with logical_axis_rules(mesh), implicit_replication():
            chi_sh, it_sh = run(placed)
            chi_bl, it_bl = run(blocked)
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

    out = {}
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
            if sharded:
                every = [None] * dist.get_world_size()
                dist.all_gather_object(every, (groups, calls))
                calls = every
            res[name] = dict(grads=[full(g).detach().numpy() for g in grads],
                             step={k: float(full(v)) for k, v in metrics.items()},
                             dispatch=calls)
        out[arch_id] = res
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

    out = {}
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
                    steps.append(dict(
                        logits=full(logits), **{k: full(cache[k]) for k in ("k", "v", "pos")},
                        placements={k: str(getattr(cache[k], "placements", None))
                                    for k in ("k", "v", "pos")}))
            res[name] = steps
        out[arch_id] = res
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
    return dict(plain=_words(chi), sharded=_words(chi_sh), live=int(chi.sum()),
                n=g.n_nodes, v=int(chi.shape[0]), adj=str(placed.adj_dense.placements))


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
    batch = {"dense": torch.as_tensor(rng.standard_normal((RECSYS_BATCH, cfg.n_dense),
                                                          dtype=np.float32)),
             "sparse": torch.as_tensor(np.stack([rng.integers(0, v, RECSYS_BATCH)
                                                 for v in RECSYS_VOCAB], 1).astype(np.int32)),
             "labels": torch.as_tensor(rng.integers(0, 2, RECSYS_BATCH).astype(np.float32))}
    plain = recsys.init_params(cfg, SEED, device="cpu")
    model = copy.deepcopy(plain)
    state_sh = arch.state_shardings(mesh, cell)
    placed = sh.place({"params": model, "opt": adamw.init(list(model.parameters()))},
                      state_sh, lambda t, ns: distribute_tensor(t.clone(), mesh, ns.placements))
    placed_batch = sh.place(dict(batch), arch.input_shardings(mesh, cell),
                            lambda t, ns: distribute_tensor(t, mesh, ns.placements))
    res = {"table": str(placed["params"].table.placements)}
    for name, state, b in (
            ("plain", {"params": plain, "opt": adamw.init(list(plain.parameters()))}, batch),
            ("sharded", placed, placed_batch)):
        implicit = implicit_replication() if name == "sharded" else contextlib.nullcontext()
        with logical_axis_rules(mesh), implicit:
            params = list(state["params"].parameters())
            grads = torch.autograd.grad(recsys.loss_fn(cfg, state["params"], b), params)
            _, metrics = arch.step(cell)(state, b)
        res[name] = dict(grads=[full(g).detach().numpy() for g in grads],
                         step={k: float(full(v)) for k, v in metrics.items()})
    return res


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
        "q_sparse": _q_sparse,
        "q_partitioned": _q_partitioned,
        "lm": lambda m: _lm(_with_model(m)),
        "lm_serve": lambda m: _lm_serve(_with_model(m), SERVE_ARCHS, LM_BATCH),
        "recsys": lambda m: _recsys(_with_model(m)),
        "block_dense": _block_dense,
    }
    if world == 4:
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
        shape, names = ((2,), ("data",)) if world == 2 else ((2, 2), ("data", "model"))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        results = {name: case(mesh) for name, case in _cases(world).items()}
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
# the plain versions, on this process
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
    import jax
    import jax.numpy as jnp

    case = _random_case(world)
    got = groups[world][f"random_{reduce}"]
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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_gnn_sharded_step_equals_plain_step(groups, world, arch_id, dtype):
    res = groups[world]["gnn"][arch_id, dtype]
    plain, sharded = res["plain"], res["sharded"]
    np.testing.assert_allclose(sharded["step"]["loss"], plain["step"]["loss"], rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(sharded["step"]["grad_norm"], plain["step"]["grad_norm"],
                               rtol=1e-5 if dtype == "float32" else 1e-12, atol=0)
    assert len(sharded["grads"]) == len(plain["grads"])
    assert (len(plain["grads"]) > 0) == (dtype == "float64")
    for k, (a, b) in enumerate(zip(sharded["grads"], plain["grads"])):
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14, err_msg=f"gradient {k}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch_id", MORE_GNN_ARCHS)
def test_more_gnn_sharded_steps_equal_plain_steps(groups, world, arch_id, dtype):
    res = groups[world]["gnn"][arch_id, dtype]
    plain, sharded = res["plain"], res["sharded"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(sharded["step"][key], plain["step"][key], rtol=1e-5,
                                   atol=0, err_msg=key)
    assert (len(plain["grads"]) > 0) == (dtype == "float64")
    assert len(sharded["grads"]) == len(plain["grads"])
    for k, (a, b) in enumerate(zip(sharded["grads"], plain["grads"])):
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14, err_msg=f"gradient {k}")


def test_q_sparse_sweep_sharded_equals_one_rank(groups):
    got = groups[2]["q_sparse"]
    assert 0 < got["live"] < got["v"] * got["n"]  # the sweep removed some, not all
    np.testing.assert_array_equal(got["sharded"], got["plain"])


def test_q_sparse_sweep_on_the_2x2_mesh_equals_one_rank(groups):
    """Chi's words split over both mesh dims (the edges too)."""
    got = groups[4]["q_sparse"]
    assert 0 < got["live"] < got["v"] * got["n"]
    np.testing.assert_array_equal(got["sharded"], got["plain"])


@pytest.mark.parametrize("world", [2, 4])
def test_q_partitioned_sweep_sharded_equals_one_rank(groups, world):
    got = groups[world]["q_partitioned"]
    assert 0 < got["live"] < got["v"] * got["n"]
    np.testing.assert_array_equal(got["sharded"], got["plain"])


@pytest.mark.parametrize("run", ["sweep", "gs", "jacobi"])
def test_query_parallel_sparse_equals_one_rank(groups, run):
    """Two queries' variables over ``data`` (the second query's split
    across the two row shards), words over ``model``, 500 nodes (16 words,
    not a multiple of the node shards' bits): chi bit for bit and the
    sweeps equal, the result's rows still split over ``data``."""
    got = groups[4]["q_parallel"]
    assert got["v"] == 8 and "Shard(dim=0)" in got["rows"]
    res = got[run]
    assert 0 < res["live"] < got["v"] * got["n"]
    assert res["sweeps"][0] == res["sweeps"][1]
    assert "Shard(dim=0)" in res["rows"]
    np.testing.assert_array_equal(res["sharded"], res["plain"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cell", ["q_sparse", "q_partitioned"])
def test_blocked_sweep_sharded_equals_one_rank(groups, world, cell):
    """The same sweeps over each shard's edges in the blocked layout (a
    card's, here through the kernel wrapper's plain version): chi bit for
    bit."""
    got = groups[world][cell]
    assert 0 < got["live"] < got["v"] * got["n"]
    np.testing.assert_array_equal(got["blocked"], got["plain"])


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
    plain, sharded = res["plain"], res["sharded"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(sharded["step"][key], plain["step"][key], rtol=1e-5,
                                   atol=0, err_msg=key)
    assert len(sharded["grads"]) == len(plain["grads"]) > 0
    for k, (a, b) in enumerate(zip(sharded["grads"], plain["grads"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"gradient {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_moe_dispatch_sharded_equals_plain(groups, world):
    """Every rank routes the groups its batch shard holds (replicated
    across the expert split) exactly as the plain step routes them."""
    res = groups[world]["lm"]["olmoe-1b-7b"]
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


@pytest.mark.parametrize("world", [2, 4])
def test_recsys_sharded_step_equals_plain_step(groups, world):
    res = groups[world]["recsys"]
    assert "Shard(dim=0)" in res["table"]  # the lookup is the sharded one
    plain, sharded = res["plain"], res["sharded"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(sharded["step"][key], plain["step"][key], rtol=1e-5,
                                   atol=0, err_msg=key)
    for k, (a, b) in enumerate(zip(sharded["grads"], plain["grads"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"gradient {k}")


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
    for i, (plain, sharded) in enumerate(zip(res["plain"], res["sharded"])):
        assert sharded["placements"] == res["want"], i
        np.testing.assert_array_equal(sharded["pos"], plain["pos"], err_msg=f"step {i}")
        for key in ("logits", "k", "v"):
            want = plain[key]
            np.testing.assert_allclose(sharded[key], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"step {i} {key}")


@pytest.mark.parametrize("arch_id", SERVE_ONE_ARCHS)
def test_lm_sharded_serving_batch_one_splits_the_sequence_four_ways(groups, arch_id):
    """Batch 1 on the 2 x 2 mesh: the cache's sequence split over ``(data,
    model)`` into 4 shards (mixtral's 8-position window, 2 a shard), each
    decode step's roll crossing both mesh dims; held as above."""
    res = _serve_cases(groups, 4, "lm_serve_one", arch_id)
    assert res["want"]["k"] == "(Shard(dim=2), Shard(dim=2))"
    assert res["want"]["pos"] == "(Replicate(), Replicate())"
    for i, (plain, sharded) in enumerate(zip(res["plain"], res["sharded"])):
        assert sharded["placements"] == res["want"], i
        np.testing.assert_array_equal(sharded["pos"], plain["pos"], err_msg=f"step {i}")
        for key in ("logits", "k", "v"):
            want = plain[key]
            np.testing.assert_allclose(sharded[key], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"step {i} {key}")


@pytest.mark.parametrize("world", [2, 4])
def test_block_dense_sweep_sharded_equals_one_rank(groups, world):
    """The dense sweep over ``DualsimArch.place``'s operands: chi bit for
    bit (the adjacency's rows over ``data``, and on the 2 x 2 mesh its
    columns and chi's over ``model``)."""
    got = groups[world]["block_dense"]
    assert 0 < got["live"] < got["v"] * got["n"]
    assert got["adj"] == ("(Shard(dim=1),)" if world == 2 else "(Shard(dim=1), Shard(dim=2))")
    np.testing.assert_array_equal(got["sharded"], got["plain"])
