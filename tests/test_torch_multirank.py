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
mesh; four ranks the 2 x 2 ``(data, model)`` mesh.

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
* one ``sparse`` dual-simulation sweep of the ``q_sparse`` cell with the
  edges and chi's columns sharded: chi's packed words bit for bit equal to
  the one-rank sweep's.
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

SEED = 0
# the ROADMAP's example: edges split 2 / 2, segment 0 = {1, 3}, segment 1 = {5, 2}
EXAMPLE = dict(vals=[1.0, 5.0, 3.0, 2.0], idx=[0, 1, 0, 1], n=2)
# segment 0's extreme 4 on three edges over both shards; segment 1 alone
TIES = dict(vals=[4.0, 1.0, 4.0, 4.0], idx=[0, 1, 0, 0], n=2, weight=[2.0, 3.0])
# segment 2 has no edge
EMPTY = dict(vals=[1.0, 5.0, 3.0, 2.0], idx=[0, 1, 0, 1], n=3, weight=[1.0, 1.0, 1.0])
GNN_ARCHS = ("pna", "gat-cora")
# a node-classification cell cut to a few hundred nodes (padded to 512 by
# GNNArch._shapes, so every mesh axis divides it)
GNN_CELL = dict(n_nodes=300, n_edges=1500, d_feat=12, n_out=3, task="node_class", n_graphs=1)
QUERY = "{ ?a p0 ?b . ?b p1 ?c . ?c p0 ?d }"


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
    return {"feat": torch.as_tensor(rng.standard_normal((n, ex["d_feat"]), dtype=np.float32)),
            "edges": torch.as_tensor(edges),
            "edge_mask": torch.as_tensor(np.arange(e) < ex["n_edges"]),
            "labels": torch.as_tensor(labels),
            "node_graph": torch.zeros(n, dtype=torch.int32)}


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
    for arch_id in GNN_ARCHS:
        for dtype, kind in (("float32", base.GNNArch), ("float64", F64Arch)):
            arch = kind(arch_id, configs.get(arch_id).reduced())
            cell = dataclasses.replace(arch.cells()["full_graph_sm"], extras=dict(GNN_CELL))
            cfg = arch.cell_cfg(cell)
            batch = _gnn_batch(arch, cell)
            batch["feat"] = batch["feat"].to(cfg.dtype)
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
                        # the zero positions GNNArch.step gives a non-geometric cell
                        zeros = torch.zeros((b["feat"].shape[0], 3), dtype=cfg.dtype)
                        params = list(state["params"].parameters())
                        loss = gnn.loss_fn(cfg, state["params"], dict(b, positions=zeros))
                        grads = torch.autograd.grad(loss, params, allow_unused=True)
                    _, metrics = arch.step(cell)(state, b)
                res[name] = dict(
                    grads=[None if g is None else full(g).detach().numpy() for g in grads],
                    step={k: float(full(v)) for k, v in metrics.items()})
            out[arch_id, dtype] = res
    return out


def _q_sparse(mesh) -> dict:
    """One ``sparse`` sweep of the q_sparse cell (``DualsimArch.step``):
    chi's packed words from the plain operands and from the operands
    placed as ``state_shardings``' rules place them (edges sharded over
    every mesh axis, chi's columns over the non-pod axes)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.core import bitops, dualsim, soi, sparql
    from repro_torch.data import synth
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules

    arch = configs.get("dualsim-lubm")
    cell = arch.cells()["q_sparse"]
    g = synth.random_graph(n_nodes=512, n_labels=2, n_edges=4096, seed=SEED)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERY)), g)
    ops = dualsim.make_sparse_operands(c, g, device="cpu")
    specs = sh.dualsim_sparse_specs(mesh)
    fields = {f.name: getattr(ops, f.name) for f in dataclasses.fields(ops)}
    placed = {}
    for name, val in fields.items():
        if name not in specs or val is None:
            placed[name] = val
            continue

        def put(t, name=name):
            return distribute_tensor(t, mesh, sh.named(mesh, t.shape, specs[name]).placements)

        placed[name] = tuple(put(t) for t in val) if isinstance(val, tuple) else put(val)
    placed_ops = dataclasses.replace(ops, **placed)
    step = arch.step(cell)
    chi, _ = step(ops, {})
    with logical_axis_rules(mesh), implicit_replication():
        chi_sh, _ = step(placed_ops, {})
    chi_sh = chi_sh.full_tensor() if isinstance(chi_sh, DTensor) else chi_sh
    return dict(plain=bitops.words_np(bitops.pack(chi)),
                sharded=bitops.words_np(bitops.pack(chi_sh)),
                live=int(chi.sum()), n=g.n_nodes, v=int(chi.shape[0]))


def _cases(world: int) -> dict:
    cases = {
        "random_amax": lambda m: _seg_reduce(m, _random_case(world), "amax"),
        "random_amin": lambda m: _seg_reduce(m, _random_case(world), "amin"),
        "gnn": _gnn,
    }
    if world == 2:
        cases.update({
            "example": lambda m: _seg_reduce(m, EXAMPLE, "amax"),
            "ties": lambda m: _seg_reduce(m, TIES, "amax"),
            "amin": lambda m: _seg_reduce(m, dict(TIES, vals=[1.0, 7.0, 1.0, 1.0]), "amin"),
            "empty": lambda m: _seg_reduce(m, EMPTY, "amax"),
            "q_sparse": _q_sparse,
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


def test_q_sparse_sweep_sharded_equals_one_rank(groups):
    got = groups[2]["q_sparse"]
    assert 0 < got["live"] < got["v"] * got["n"]  # the sweep removed some, not all
    np.testing.assert_array_equal(got["sharded"], got["plain"])
