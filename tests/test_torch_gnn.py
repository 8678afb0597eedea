"""The port's GNN family and neighbour sampler against the JAX package.

Each case draws the JAX package's parameters, hands them over as numpy
(``convert.gnn_params_from_numpy``) and feeds both packages the same batch,
made from a seed with numpy; the JAX package's losses, gradients and
steps run under ``jax.jit`` (op by op they take ten times as long).
Tolerances: the segment ops at f32 rtol
1e-6, atol 1e-6 (a segment's elements are summed in another order); the
four architectures' forward and loss at rtol 1e-5 with atol 1e-5 times the
output's largest magnitude, gradients at rtol 1e-4 with atol 1e-4 times
the tensor's largest |gradient| (two BLAS libraries round their sums
differently); ``GNNArch.step`` on the f32 cells at rtol 1e-4 (loss,
gradient norm, parameters), and on ``ogb_products``, whose config runs
bf16 activations, at the bf16 tolerance of the LM tests, rtol 2e-2, with
parameters also allowed the two learning rates by which a flipped sign
of a near-zero bf16 gradient moves AdamW's first step.  The
sampler is numpy in both packages and must give identical blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import gnn as ref_gnn
from repro.models import sampler as ref_sampler
from repro.optimizer import adamw as ref_adamw
from repro_torch import configs, convert
from repro_torch.configs import base
from repro_torch.models import gnn, sampler
from repro_torch.optimizer import adamw

ARCHS = ["gatedgcn", "gat", "pna", "schnet"]
GNN_IDS = ["gatedgcn", "gat-cora", "pna", "schnet"]
SEG = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


def _batch(rng, n=40, e=160, f=8, n_graphs=1, task="node_class", n_out=3, mask_p=0.0):
    """``tests/test_models_gnn.py``'s batch as numpy, with a share
    ``mask_p`` of the edges masked."""
    b = {
        "feat": rng.normal(size=(n, f)).astype(np.float32),
        "edges": np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1).astype(np.int32),
        "edge_mask": rng.random(e) >= mask_p,
        "node_graph": (np.arange(n) % n_graphs).astype(np.int32),
        "positions": rng.normal(size=(n, 3)).astype(np.float32),
    }
    if task == "graph_reg":
        b["labels"] = rng.normal(size=n_graphs).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, n_out, n).astype(np.int32)
    return b


def _both(b: dict, n_graphs=None):
    """The numpy batch as JAX arrays and as CPU tensors (``n_graphs`` as int)."""
    ref = {k: jnp.asarray(v) for k, v in b.items()}
    port = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    if n_graphs is not None:
        ref["n_graphs"] = port["n_graphs"] = n_graphs
    return ref, port


def _cfgs(arch, task, **kw):
    kw = dict(name=arch, arch=arch, n_layers=2, d_hidden=16, d_in=8, n_out=3,
              n_heads=4, task=task, n_rbf=16, cutoff=5.0, **kw)
    return ref_gnn.GNNConfig(**kw), gnn.GNNConfig(**kw)


def _params(ref_cfg, cfg, seed=0):
    ref_p = ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_p, convert.gnn_params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                                                device="cpu")


def _leaf(tree, name):
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return np.asarray(node)


def _case(arch, task, mask_p=0.0, seed=0):
    rng = np.random.default_rng(seed)
    n_graphs = 4 if task == "graph_reg" else 1
    b = _batch(rng, n_graphs=n_graphs, task=task, mask_p=mask_p)
    if arch == "schnet" and task == "graph_reg":
        b["feat"] = rng.integers(1, 10, 40).astype(np.int32)
    return _both(b, n_graphs if task == "graph_reg" else None)


# --------------------------------------------------------------------- #
# the four architectures x two tasks
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
def test_forward_loss_grad_match_reference(arch, task):
    ref_cfg, cfg = _cfgs(arch, task)
    ref_p, model = _params(ref_cfg, cfg)
    ref_b, b = _case(arch, task, mask_p=0.2)
    want = np.asarray(ref_gnn.forward(ref_cfg, ref_p, ref_b))
    got = _np(gnn.forward(cfg, model, b))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    want_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_gnn.loss_fn(ref_cfg, p, ref_b)))(ref_p)
    loss = gnn.loss_fn(cfg, model, b)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    tree = jax.tree.map(np.asarray, ref_g)
    assert len(names) == len(jax.tree.leaves(tree))
    for name, g in zip(names, grads):
        want_g = _leaf(tree, name)
        got_g = np.zeros_like(want_g) if g is None else _np(g)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_g).max(), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    _, cfg = _cfgs(arch, "node_class")
    model = gnn.init_params(cfg, 0, device="cpu")
    _, b = _case(arch, "node_class", mask_p=0.2)
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=False)):
        loss = gnn.loss_fn(c, model, b)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()),
                                              allow_unused=True)))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert (a is None and c is None) or torch.equal(a, c)


def test_edge_mask_zeroes_padded_edges():
    """A padded (masked) edge must not change the output."""
    _, cfg = _cfgs("gatedgcn", "node_class")
    cfg = dataclasses.replace(cfg, d_hidden=8, d_in=4, n_out=2)
    model = gnn.init_params(cfg, 0, device="cpu")
    _, b = _both(_batch(np.random.default_rng(0), n=10, e=20, f=4))
    out1 = gnn.forward(cfg, model, b)
    b2 = dict(b, edges=torch.cat([b["edges"], torch.tensor([[0, 5]], dtype=torch.int32)]),
              edge_mask=torch.cat([b["edge_mask"], torch.tensor([False])]))
    out2 = gnn.forward(cfg, model, b2)
    torch.testing.assert_close(out1, out2, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_init_scale(arch):
    ref_cfg, cfg = _cfgs(arch, "node_class")
    ref_p, model = _params(ref_cfg, cfg)
    tree = jax.tree.map(np.asarray, ref_p)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(jax.tree.leaves(tree))
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(_np(p), _leaf(tree, name), err_msg=name)
    fresh = gnn.init_params(cfg, 0, device="cpu")
    again = gnn.init_params(cfg, 0, device="cpu")
    for (name, p), q, (_, r) in zip(fresh.named_parameters(), again.parameters(),
                                    model.named_parameters()):
        assert p.shape == r.shape and torch.equal(p, q), name
        if name.endswith(".b") or name == "edge_embed":
            assert not bool(p.any()), name
    wide = gnn.init_params(dataclasses.replace(cfg, d_hidden=256), 1, device="cpu")
    w = dict(wide.named_parameters())["layers.0.W" if arch == "gat" else
                                      "layers.0.lin1.w" if arch == "schnet" else
                                      "layers.0.pre.w" if arch == "pna" else "layers.0.A.w"]
    assert abs(float(w.detach().std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05  # 1/sqrt(fan_in)


def test_params_from_numpy_refuses_a_wrong_tree():
    ref_cfg, _ = _cfgs("pna", "node_class")
    _, cfg = _cfgs("gatedgcn", "node_class")
    tree = jax.tree.map(np.asarray, ref_gnn.init_params(ref_cfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError):
        convert.gnn_params_from_numpy(tree, cfg, device="cpu")


# --------------------------------------------------------------------- #
# segment ops
# --------------------------------------------------------------------- #
def _seg_case(seed, e=50, n=9, width=(3,)):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(e, *width)).astype(np.float32)
    idx = rng.integers(0, n - 2, e).astype(np.int32)  # the last two segments empty
    return vals, idx, n


@pytest.mark.parametrize("op,width", [
    (op, w) for op in ("seg_sum", "seg_max", "seg_min", "seg_softmax")
    for w in ((), (3,), (2, 4))] + [("seg_mean", (3,))])  # a mean's degree is [N, 1]
def test_segment_ops_match_reference(op, width):
    vals, idx, n = _seg_case(1, width=width)
    want = np.asarray(getattr(ref_gnn, op)(jnp.asarray(vals), jnp.asarray(idx), n))
    got = _np(getattr(gnn, op)(torch.from_numpy(vals), torch.from_numpy(idx), n))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **SEG)
    if op != "seg_softmax":
        assert not want[n - 2:].any() and not got[n - 2:].any()  # empty segments give 0


def test_segment_ops_with_degree_and_masked_edges():
    """``seg_mean`` over a given degree, and messages of masked edges
    (zeroed, as every architecture masks them) over the max, min and mean."""
    vals, idx, n = _seg_case(2, width=(5,))
    mask = (np.random.default_rng(3).random(len(idx)) > 0.3).astype(np.float32)[:, None]
    msg = np.maximum(vals, 0) * mask
    deg = np.zeros((n, 1), np.float32)
    np.add.at(deg, idx, mask)
    for op, args in (("seg_mean", (deg,)), ("seg_max", ()), ("seg_min", ()), ("seg_sum", ())):
        want = np.asarray(getattr(ref_gnn, op)(jnp.asarray(msg), jnp.asarray(idx), n,
                                               *map(jnp.asarray, args)))
        got = _np(getattr(gnn, op)(torch.from_numpy(msg), torch.from_numpy(idx), n,
                                   *map(torch.from_numpy, args)))
        np.testing.assert_allclose(got, want, err_msg=op, **SEG)


def test_segment_max_gradient_matches_reference_without_ties():
    vals, idx, n = _seg_case(4, width=(3,))
    w = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)
    for op in ("seg_max", "seg_min"):
        want = jax.grad(lambda v: jnp.sum(getattr(ref_gnn, op)(v, jnp.asarray(idx), n) * w))(
            jnp.asarray(vals))
        v = torch.from_numpy(vals).requires_grad_()
        (getattr(gnn, op)(v, torch.from_numpy(idx), n) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(_np(v.grad), np.asarray(want), err_msg=op, **SEG)


@pytest.mark.parametrize("chunk", [1, 24, 1 << 28])
def test_gat_aggregation_in_edge_chunks_equals_the_plain_formula(monkeypatch, chunk):
    """GAT's ``seg_sum(alpha[:, :, None] * hw[src], dst, n)`` over edge
    chunks (one edge, a few, all of them) gives the plain formula's output
    and gradients."""
    rng = np.random.default_rng(9)
    e, n, h, d = 37, 11, 2, 4
    alpha = torch.from_numpy(rng.random((e, h)).astype(np.float32)).requires_grad_()
    hw = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32)).requires_grad_()
    src, dst = (torch.from_numpy(rng.integers(0, n, e)) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(n, h, d)).astype(np.float32))
    want = gnn.seg_sum(alpha[:, :, None] * hw[src], dst, n)
    want_g = torch.autograd.grad((want * w).sum(), (alpha, hw))
    monkeypatch.setattr(gnn, "EDGE_CHUNK", chunk)
    got = gnn._WeightedGatherScatter.apply(alpha, hw, src, dst, n)
    got_g = torch.autograd.grad((got * w).sum(), (alpha, hw))
    torch.testing.assert_close(got, want, **SEG)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, **SEG)


def test_gat_attention_normalizes():
    """Per-destination attention weights sum to 1 over real edges, equal
    the reference's, and a masked edge's ``-1e30`` logit gets weight 0."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(12, 2)).astype(np.float32)
    logits[3] = -1e30
    idx = rng.integers(0, 4, 12).astype(np.int32)
    alpha = gnn.seg_softmax(torch.from_numpy(logits), torch.from_numpy(idx), 4)
    want = np.asarray(ref_gnn.seg_softmax(jnp.asarray(logits), jnp.asarray(idx), 4))
    np.testing.assert_allclose(_np(alpha), want, **SEG)
    sums = _np(gnn.seg_sum(alpha, torch.from_numpy(idx), 4))
    nonempty = np.isin(np.arange(4), idx)
    np.testing.assert_allclose(sums[nonempty], 1.0, atol=1e-5)
    assert not sums[~nonempty].any()
    assert not _np(alpha)[3].any()
    half = gnn.seg_softmax(torch.from_numpy(logits).to(torch.bfloat16),
                           torch.from_numpy(idx), 4)
    assert half.dtype == torch.bfloat16 and not bool(half[3].any())


# --------------------------------------------------------------------- #
# the neighbour sampler
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fanout", [(5, 3), (15, 10), (4,)])
def test_sampler_blocks_identical(fanout):
    rng = np.random.default_rng(7)
    n, e = 500, 6000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    ref = ref_sampler.NeighborSampler(n, edges, seed=3)
    port = sampler.NeighborSampler(n, edges, seed=3)
    assert sampler.block_sizes(32, fanout) == ref_sampler.block_sizes(32, fanout)
    for _ in range(3):  # the generators advance in step
        seeds = rng.choice(n, 32, replace=False)
        want, got = ref.sample(seeds, fanout), port.sample(seeds, fanout)
        for f in ("node_ids", "node_mask", "edges", "edge_mask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert got.n_seeds == want.n_seeds


# --------------------------------------------------------------------- #
# GNNArch: every cell's step at reduced widths
# --------------------------------------------------------------------- #
def _cell_batch(cell, arch_id, rng):
    """A small batch in ``cell``'s format: its feature width, classes and
    task; a sampled block for ``minibatch_lg``; 128 tiny graphs for
    ``molecule``."""
    ex = cell.extras
    if cell.name == "minibatch_lg":
        n_g, e_g = 400, 4000
        g_edges = np.stack([rng.integers(0, n_g, e_g), rng.integers(0, n_g, e_g)], 1)
        blk = sampler.NeighborSampler(n_g, g_edges, seed=0).sample(
            rng.choice(n_g, 4, replace=False), ex["fanout"])
        feats = rng.normal(size=(n_g, ex["d_feat"])).astype(np.float32)
        labels = np.full(len(blk.node_ids), -1, np.int32)
        labels[:4] = rng.integers(0, ex["n_out"], 4)
        n = len(blk.node_ids)
        b = {"feat": feats[blk.node_ids], "edges": blk.edges, "edge_mask": blk.edge_mask,
             "labels": labels}
    elif cell.name == "molecule":
        g, per, eper = ex["n_graphs"], 3, 4
        n = g * per
        node_graph = np.arange(n) // per
        src = rng.integers(0, per, g * eper) + np.repeat(np.arange(g) * per, eper)
        dst = rng.integers(0, per, g * eper) + np.repeat(np.arange(g) * per, eper)
        feat = (rng.integers(1, 10, n).astype(np.int32) if arch_id == "schnet"
                else rng.normal(size=(n, ex["d_feat"])).astype(np.float32))
        b = {"feat": feat, "edges": np.stack([src, dst], 1).astype(np.int32),
             "edge_mask": np.ones(g * eper, bool),
             "labels": rng.normal(size=g).astype(np.float32),
             "node_graph": node_graph.astype(np.int32),
             "positions": rng.normal(size=(n, 3)).astype(np.float32)}
        return b
    else:
        n, e = 60, 240
        b = {"feat": rng.normal(size=(n, ex["d_feat"])).astype(np.float32),
             "edges": np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
             .astype(np.int32),
             "edge_mask": rng.random(e) > 0.1,
             "labels": rng.integers(0, ex["n_out"], n).astype(np.int32)}
    b["node_graph"] = np.zeros(n, np.int32)
    return b


@pytest.mark.parametrize("arch_id", GNN_IDS)
@pytest.mark.parametrize("cell_name", list(base.GNN_SHAPES))
def test_arch_step_matches_reference(arch_id, cell_name):
    ref_spec, spec = ref_configs.get(arch_id), configs.get(arch_id)
    ref_arch = type(ref_spec)(arch_id, ref_spec.reduced())
    arch = base.GNNArch(arch_id, spec.reduced())
    ref_cell, cell = ref_arch.cells()[cell_name], arch.cells()[cell_name]
    assert cell == base.Cell(ref_cell.name, ref_cell.kind, extras=ref_cell.extras)
    ref_cfg, cfg = ref_arch.cell_cfg(ref_cell), arch.cell_cfg(cell)
    assert cfg.d_in == ref_cfg.d_in and cfg.n_out == ref_cfg.n_out
    assert arch.model_flops(cell) == ref_arch.model_flops(ref_cell)
    ref_p, model = _params(ref_cfg, cfg)
    b = _cell_batch(cell, arch_id, np.random.default_rng(11))
    ref_b, port_b = _both(b)
    ref_state, metrics_ref = jax.jit(ref_arch.step(ref_cell))(
        {"params": ref_p, "opt": ref_adamw.init(ref_p)}, ref_b)
    state, metrics = arch.step(cell)(
        {"params": model, "opt": adamw.init(list(model.parameters()))}, port_b)
    assert state["params"] is model and int(state["opt"]["step"]) == 1
    rtol = 2e-2 if cfg.dtype == torch.bfloat16 else 1e-4
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]), float(metrics_ref[key]),
                                   rtol=rtol, err_msg=key)
    # bf16 gradients can flip the sign of AdamW's first step, g / (|g| + eps),
    # where a gradient is near zero: such a parameter lands lr away either way
    step_atol = 2 * float(metrics_ref["lr"]) if cfg.dtype == torch.bfloat16 else 0.0
    tree = jax.tree.map(np.asarray, ref_state["params"])
    for name, p in model.named_parameters():
        want = _leaf(tree, name)
        np.testing.assert_allclose(_np(p), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max() + step_atol, err_msg=name)


def test_cells_match_reference():
    ref_arch = ref_configs.get("gatedgcn")
    arch = configs.get("gatedgcn")
    for name, cell in arch.cells().items():
        assert arch._shapes(cell) == ref_arch._shapes(ref_arch.cells()[name])
        assert (arch.cell_cfg(cell).dtype == torch.bfloat16) == (name == "ogb_products")
    for arch_id in GNN_IDS:
        got, want = configs.get(arch_id).reduced(), ref_configs.get(arch_id).reduced()
        for f in ("arch", "n_layers", "d_hidden", "d_in", "n_out", "n_heads", "n_rbf",
                  "cutoff", "task", "remat"):
            assert getattr(got, f) == getattr(want, f), (arch_id, f)
