"""The port's sharded paths on a real 3-D ``(pod, data, model)`` mesh of 8
gloo ranks, held against their plain versions on one process.

``multipod``, the 2 x 16 x 16 production mesh, is the only one with a
``pod`` axis, and ``pod`` is where the rules mix: it splits the batch
``(pod, data)``, the edges and the MoE tokens ``(pod, data, model)``,
while the tensors those inputs meet (dcn-v2's table rows, the GNN nodes,
chi's columns, the retrieval candidates) are split over ``(data, model)``
alone and replicated on ``pod``.  This module spawns one gloo group of 8
ranks as ``init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod",
"data", "model"))`` through ``tests.test_torch_multirank``'s harness
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous, one thread a
rank, rank 0 handing the results back), runs that module's case builders
in it, and holds them with its checks, at the tolerances its 2 x 2 cases
use:

* ``ctx.segment_reduce``'s max and min over edges split 8 ways: values
  and gradient equal to ``scatter_reduce``'s exactly, the gradient within
  f32 rtol 1e-5 of ``jax.grad`` of ``segment_max`` / ``segment_min``;
* the four GNNs' ``full_graph_sm`` node step and their ``molecule`` step
  (8 graphs of 30 nodes and 64 edges, the ``graph_reg`` readout over
  ``node_graph``; schnet on int32 atom types), edges over ``(pod, data,
  model)`` and nodes over ``(data, model)``: in f32 the loss and gradient
  norm within rtol 1e-5; in f64 each arch once (``F64_ON_8``: pna and gat
  on the node cell, their norm within 1e-12; gatedgcn and schnet on the
  molecule cell, where every readout path runs), every gradient within
  rtol 1e-12, atol 1e-14 (the 2- and 4-rank groups hold every arch in f64
  on both cells);
* chi's packed words bit for bit: one ``q_sparse`` and one
  ``q_partitioned`` sweep, the query-parallel batch (one sweep, and the
  whole fixpoint in Gauss-Seidel and Jacobi order, in as many sweeps) and
  one ``block_dense`` sweep, each with flat edges and, but for
  ``block_dense``, with each shard's edges in the blocked layout a card
  gets; the operands placed as ``DualsimArch.spec_for`` gives them;
* internlm2's, qwen3's and olmoe's ``reduced()`` train steps, the batch
  over ``(pod, data)``: f32 loss and gradient norm within rtol 1e-5, every
  gradient within rtol 1e-4 (atol 1e-4 times its largest magnitude), and
  every rank's MoE dispatch equal exactly to the plain dispatch of its
  groups;
* the four LMs' prefill and three decode steps at batch 4 (the batch over
  ``(pod, data)``, the cache's sequence over ``model``) and internlm2's
  and mixtral's at batch 1 (the sequence over ``(data, model)``, ``pod``
  replicated): logits and cache within rtol 1e-5 (atol 1e-5 times the
  largest magnitude), ``pos`` exactly, the cache in ``lm_cache_spec``'s
  3-D placement after every step;
* dcn-v2's train step, 180 table rows over ``(data, model)`` and a batch
  of 16 over ``(pod, data)`` (the table's gradient summed over ``pod``):
  as the LMs'; its ``serve_p99`` and ``serve_bulk`` sigmoid outputs (batch
  16 and 64) within rtol 1e-5, and ``retrieval_cand`` over 512 candidates
  split over ``(data, model)``: the scores within rtol 1e-5, the top 100
  exactly, with the outputs' placements stated;
* replica agreement, bit for bit, after every case: each rank's local
  shard of every parameter, optimizer moment, gradient and output equals
  that of every rank at its coordinate on the mesh dims that split it
  (so the two ``pod`` replicas of a ``(data, model)``-split table hold
  one table), and every rank reads the same scalar metrics.

The 8 ranks take about three minutes on an idle 8-core CPU.
"""
from __future__ import annotations

import itertools

import pytest

from tests.test_torch_multirank import (
    F64_ON_8,
    GNN_ARCHS,
    LM_ARCHS,
    MORE_GNN_ARCHS,
    SERVE_ARCHS,
    SERVE_ONE_ARCHS,
    _check_dispatch,
    _check_gnn,
    _check_grads,
    _check_q_parallel,
    _check_recsys_serve,
    _check_replicas,
    _check_segment_extreme,
    _check_serving,
    _check_words,
    _replica_cases,
    _spawn,
)

WORLD = 8
REP = "Replicate()"


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """{case: rank 0's results} of the one 8-rank ``(pod, data, model)``
    group, with every rank's records under ``"replicas"``."""
    return _spawn(str(tmp_path_factory.mktemp("multipod")), WORLD)


def test_group_is_the_2x2x2_pod_data_model_mesh(pod):
    coords = sorted(every["q_sparse", "chi"][0] for every in pod["replicas"])
    assert coords == sorted(itertools.product(range(2), repeat=3))


@pytest.mark.parametrize("reduce", ["amax", "amin"])
def test_segment_extreme_gradient_matches_jax_on_2x2x2(pod, reduce):
    _check_segment_extreme(pod[f"random_{reduce}"], WORLD, reduce)


def _gnn_params(cell: str) -> list[tuple[str, str]]:
    return ([(a, "float32") for a in GNN_ARCHS + MORE_GNN_ARCHS]
            + [(a, "float64") for a in F64_ON_8[cell]])


@pytest.mark.parametrize("arch_id,dtype", _gnn_params("gnn"))
def test_gnn_node_step_on_2x2x2_equals_plain_step(pod, arch_id, dtype):
    exact_norm = dtype == "float64" and arch_id in GNN_ARCHS
    _check_gnn(pod["gnn"][arch_id, dtype], dtype, 1e-12 if exact_norm else 1e-5)


@pytest.mark.parametrize("arch_id,dtype", _gnn_params("molecule"))
def test_gnn_molecule_step_on_2x2x2_equals_plain_step(pod, arch_id, dtype):
    _check_gnn(pod["molecule"][arch_id, dtype], dtype, 1e-5)


@pytest.mark.parametrize("layout", ["sharded", "blocked"])
@pytest.mark.parametrize("cell", ["q_sparse", "q_partitioned"])
def test_sweep_on_2x2x2_equals_one_rank(pod, cell, layout):
    """Chi's words over ``(data, model)``, replicated on ``pod``: bit for
    bit, flat and blocked."""
    got = pod[cell]
    assert got["init"] == got["want"] == f"({REP}, Shard(dim=1), Shard(dim=1))"
    _check_words(got, layout)


@pytest.mark.parametrize("run", ["sweep", "gs", "jacobi"])
def test_query_parallel_sparse_on_2x2x2_equals_one_rank(pod, run):
    """The query variables over ``data``, the words over ``model``, ``pod``
    replicated: chi bit for bit, flat and blocked, in as many sweeps."""
    got = pod["q_parallel"]
    assert got["want"] == f"({REP}, Shard(dim=0), Shard(dim=1))"
    _check_q_parallel(got, run)


def test_block_dense_sweep_on_2x2x2_equals_one_rank(pod):
    got = pod["block_dense"]
    assert got["adj"] == got["want"] == f"({REP}, Shard(dim=1), Shard(dim=2))"
    _check_words(got)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_step_on_2x2x2_equals_plain_step(pod, arch_id):
    res = pod["lm"][arch_id]
    _check_grads(res["sharded"], res["plain"])


def test_moe_dispatch_on_2x2x2_equals_plain(pod):
    """Four token groups, one a ``(pod, data)`` shard, each routed on the
    two ranks of its expert split as the plain step routes it."""
    res = pod["lm"]["olmoe-1b-7b"]
    assert {g for (g, _), _ in res["sharded"]["dispatch"]} == {0, 1, 2, 3}
    _check_dispatch(res)


@pytest.mark.parametrize("arch_id", SERVE_ARCHS)
def test_lm_serving_on_2x2x2_equals_plain_serving(pod, arch_id):
    """Batch 4 over ``(pod, data)``, the cache's sequence over ``model``."""
    res = pod["lm_serve"][arch_id]
    assert res["want"]["k"] == "(Shard(dim=1), Shard(dim=1), Shard(dim=2))"
    assert res["want"]["pos"] == f"(Shard(dim=0), Shard(dim=0), {REP})"
    _check_serving(res)


@pytest.mark.parametrize("arch_id", SERVE_ONE_ARCHS)
def test_lm_serving_batch_one_on_2x2x2_equals_plain_serving(pod, arch_id):
    """Batch 1: the cache's sequence over ``(data, model)``, ``pod``
    replicated."""
    res = pod["lm_serve_one"][arch_id]
    assert res["want"]["k"] == f"({REP}, Shard(dim=2), Shard(dim=2))"
    assert res["want"]["pos"] == f"({REP}, {REP}, {REP})"
    _check_serving(res)


def test_recsys_step_on_2x2x2_equals_plain_step(pod):
    """The table's rows over ``(data, model)`` and the batch over ``(pod,
    data)``: the table's gradient is summed over ``pod``."""
    res = pod["recsys"]
    assert res["table"] == f"({REP}, Shard(dim=0), Shard(dim=0))"
    _check_grads(res["sharded"], res["plain"])


@pytest.mark.parametrize("cell", ["serve_p99", "serve_bulk", "retrieval_cand"])
def test_recsys_serving_on_2x2x2_equals_plain(pod, cell):
    """The batch over ``(pod, data)``; the sigmoid outputs come back split
    over all three mesh dims, the scores over the candidates' ``(data,
    model)``, the top 100 whole."""
    res = pod["recsys_serve"]
    _check_recsys_serve(res, cell)
    if cell == "retrieval_cand":
        assert res[cell]["placements"] == [f"({REP}, Shard(dim=1), Shard(dim=1))",
                                           f"({REP}, {REP}, {REP})"]
    else:
        assert res[cell]["batch"] == f"(Shard(dim=0), Shard(dim=0), {REP})"
        assert res[cell]["placements"] == ["(Shard(dim=0), Shard(dim=0), Shard(dim=0))"]


@pytest.mark.parametrize("case", _replica_cases(WORLD))
def test_replicas_agree_bit_for_bit_on_2x2x2(pod, case):
    """Ranks that differ only where a tensor is replicated (``pod`` for
    every ``(data, model)``-split state) hold it bit for bit alike, and
    every rank reads the same scalar metrics."""
    _check_replicas(pod["replicas"], case)
