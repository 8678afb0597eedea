"""The port's DCN-v2 recsys model and its ArchSpec against the JAX package.

Each case draws the JAX package's parameters, hands them over as numpy
(``convert.recsys_params_from_numpy``) and feeds both packages the same
batch, made from a seed with numpy.  Tolerances, the LM path's: forward
and loss at f32 rtol 1e-5 with atol 1e-5 times the output's largest
magnitude; gradients and the train step at rtol 1e-4 with atol 1e-4 times
the tensor's largest magnitude (two BLAS libraries round their sums
differently); the EmbeddingBag at rtol 1e-6 (a bag's rows are summed in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import recsys as ref_recsys
from repro.models import steps as ref_steps
from repro.optimizer import adamw as ref_adamw
from repro_torch import configs, convert
from repro_torch.configs import base
from repro_torch.models import recsys
from repro_torch.optimizer import adamw

FWD = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(**kw):
    """``tests/test_models_recsys.py``'s tiny config in both packages."""
    kw = dict(name="tiny", n_dense=4, n_sparse=3, embed_dim=8, n_cross=2,
              mlp=(32, 16), vocab_sizes=(97, 31, 53), **kw)
    return ref_recsys.RecsysConfig(**kw), recsys.RecsysConfig(**kw)


def _reduced():
    ref_cfg = ref_configs.get("dcn-v2").reduced()
    cfg = configs.get("dcn-v2").reduced()
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed=0):
    ref_p = ref_recsys.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_p, convert.recsys_params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                                                   device="cpu")


def _batch(rng, cfg, b=16):
    return {
        "dense": rng.normal(size=(b, cfg.n_dense)).astype(np.float32),
        "sparse": (rng.random((b, cfg.n_sparse)) * np.asarray(cfg.vocab_sizes)).astype(np.int32),
        "labels": rng.integers(0, 2, b).astype(np.float32),
    }


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()})


def _close(got, want, rtol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


def _leaf(tree, name):
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return np.asarray(node)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["tiny", "dcn-v2-reduced"])
def test_forward_loss_grad_match_reference(which, rng):
    ref_cfg, cfg = _cfgs() if which == "tiny" else _reduced()
    ref_p, model = _params(ref_cfg, cfg)
    ref_b, b = _both(_batch(rng, cfg))
    want = np.asarray(ref_recsys.forward(ref_cfg, ref_p, ref_b))
    got = recsys.forward(cfg, model, b)
    assert got.shape == (16,)
    _close(got, want, **FWD)
    want_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_recsys.loss_fn(ref_cfg, p, ref_b)))(ref_p)
    loss = recsys.loss_fn(cfg, model, b)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **FWD)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    tree = jax.tree.map(np.asarray, ref_g)
    assert len(names) == len(jax.tree.leaves(tree))
    for name, g in zip(names, grads):
        _close(g, _leaf(tree, name), **GRAD, err_msg=name)


def test_param_names_and_shapes_match_reference_tree():
    ref_cfg, cfg = _reduced()
    ref_p = jax.eval_shape(lambda k: ref_recsys.init_params(ref_cfg, k), jax.random.PRNGKey(0))
    model = recsys.init_params(cfg, seed=0, device="cpu")
    for name, p in model.named_parameters():
        node = ref_p
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert tuple(p.shape) == tuple(node.shape), name
    assert float(model.table.detach().std()) == pytest.approx(0.01, rel=0.1)
    assert not any(float(p.abs().sum()) for n, p in model.named_parameters()
                   if n.endswith(".b"))
    again = recsys.init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    ref_cfg, cfg = _cfgs()
    ref_p, model = _params(ref_cfg, cfg)
    vals = np.asarray([3, 7, 1, 1, 9, 2], np.int32)
    segs = np.asarray([0, 0, 0, 1, 2, 2], np.int32)
    want = ref_recsys.embedding_bag(ref_p["table"], jnp.asarray(vals), jnp.asarray(segs), 4,
                                    mode=mode)
    got = recsys.embedding_bag(model.table.detach(), torch.from_numpy(vals),
                               torch.from_numpy(segs), 4, mode=mode)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    t = np.asarray(ref_p["table"])
    exp0 = t[3] + t[7] + t[1]
    np.testing.assert_allclose(_np(got[0]), exp0 / (3 if mode == "mean" else 1), rtol=1e-6)
    assert not _np(got[3]).any()  # empty bag -> zeros


def test_multi_hot_path_equals_single_hot(rng):
    """A bag with nnz=1 per (row, feature) == the plain gather path."""
    ref_cfg, cfg = _cfgs()
    ref_p, model = _params(ref_cfg, cfg)
    b = _batch(rng, cfg, b=6)
    idx = (b["sparse"] + cfg.offsets()[None, :]).reshape(-1)
    b2 = dict(b, bag_values=idx.astype(np.int32),
              bag_segments=np.arange(6 * cfg.n_sparse, dtype=np.int32))
    ref_b2, port_b2 = _both(b2)
    out1 = recsys.forward(cfg, model, _both(b)[1])
    out2 = recsys.forward(cfg, model, port_b2)
    np.testing.assert_allclose(_np(out2), _np(out1), rtol=1e-5)
    _close(out2, ref_recsys.forward(ref_cfg, ref_p, ref_b2), **FWD)


def test_cross_layer_identity_at_zero_weights(rng):
    """x_{l+1} = x0 * (0 + 0) + x_l = x_l when W = b = 0: the trunk equals
    one with no cross layers."""
    ref_cfg, cfg = _cfgs()
    _, model = _params(ref_cfg, cfg)
    with torch.no_grad():
        for c in model.cross:
            c.w.zero_()
            c.b.zero_()
    b = _both(_batch(rng, cfg, b=4))[1]
    bare = recsys.Recsys(dataclasses.replace(cfg, n_cross=0), "cpu")
    with torch.no_grad():
        for name, p in bare.named_parameters():
            p.copy_(model.get_parameter(name))
    out = recsys.forward(cfg, model, b)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, recsys.forward(dataclasses.replace(cfg, n_cross=0), bare, b),
                               rtol=0, atol=0)


def test_retrieval_topk_matches_reference(rng):
    ref_cfg, cfg = _cfgs()
    ref_p, model = _params(ref_cfg, cfg)
    b = _batch(rng, cfg, b=2)
    b["candidates"] = rng.normal(size=(500, cfg.mlp[-1])).astype(np.float32)
    ref_b, port_b = _both(b)
    want_s, want_top = ref_recsys.retrieval_score(ref_cfg, ref_p, ref_b)
    scores, top = recsys.retrieval_score(cfg, model, port_b)
    assert tuple(top.shape) == (2, 100)
    _close(scores, want_s, **FWD)
    s = _np(scores)
    exp = np.argsort(-s, axis=1)[:, :100]
    # the same score values (ties may permute indices), and the reference's
    # top-100 read the same scores
    np.testing.assert_allclose(np.take_along_axis(s, top.numpy(), 1),
                               np.take_along_axis(s, exp, 1), rtol=1e-6)
    np.testing.assert_allclose(np.take_along_axis(s, np.asarray(want_top), 1),
                               np.take_along_axis(s, exp, 1), rtol=1e-5)


# --------------------------------------------------------------------- #
# RecsysArch
# --------------------------------------------------------------------- #
def test_cells_flops_and_inputs_match_reference():
    ref_spec, spec = ref_configs.get("dcn-v2"), configs.get("dcn-v2")
    assert spec.cfg.total_vocab == ref_spec.cfg.total_vocab == 33_762_577
    assert spec.cfg.d_interact == ref_spec.cfg.d_interact
    for name, cell in spec.cells().items():
        ref_cell = ref_spec.cells()[name]
        assert cell == base.Cell(ref_cell.name, ref_cell.kind, ref_cell.batch, ref_cell.seq,
                                 ref_cell.microbatches, ref_cell.extras)
        assert spec.model_flops(cell) == ref_spec.model_flops(ref_cell)
        assert spec.skip_reason(name) is None
        ref_in, got = ref_spec.abstract_inputs(ref_cell), spec.abstract_inputs(cell)
        assert set(ref_in) == set(got)
        for k, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == ref_in[k].shape
            assert str(leaf.dtype).split(".")[-1] == str(ref_in[k].dtype)
    got, want = spec.reduced(), ref_spec.reduced()
    for f in ("vocab_sizes", "n_sparse", "n_dense", "embed_dim", "n_cross", "mlp"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("microbatches", [1, 2])
def test_arch_train_step_matches_reference(microbatches, rng):
    """``RecsysArch.step`` on the train cell at reduced widths (the JAX
    package's ``test_recsys_reduced_smoke`` step, held to the reference)."""
    ref_spec, spec = ref_configs.get("dcn-v2"), configs.get("dcn-v2")
    ref_cfg, cfg = _reduced()
    ref_arch, arch = type(ref_spec)(ref_cfg), base.RecsysArch(cfg)
    ref_cell = dataclasses.replace(ref_arch.cells()["train_batch"], batch=8,
                                   microbatches=microbatches)
    cell = dataclasses.replace(arch.cells()["train_batch"], batch=8, microbatches=microbatches)
    ref_p, model = _params(ref_cfg, cfg)
    ref_b, b = _both(_batch(rng, cfg, b=8))
    ref_state, m_ref = jax.jit(ref_arch.step(ref_cell))(
        {"params": ref_p, "opt": ref_adamw.init(ref_p)}, ref_b)
    state, m = arch.step(cell)({"params": model, "opt": adamw.init(list(model.parameters()))}, b)
    assert state["params"] is model and int(state["opt"]["step"]) == 1
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(m_ref[key]), **GRAD, err_msg=key)
    tree = jax.tree.map(np.asarray, ref_state["params"])
    for name, p in model.named_parameters():
        _close(p, _leaf(tree, name), **GRAD, err_msg=name)


def test_reduced_smoke_step_matches_reference(rng):
    """``tests/test_configs.py::test_recsys_reduced_smoke`` in both packages:
    ``make_train_step`` with AdamW(lr=1e-3) from the JAX package's
    parameters, the loss and the forward after it."""
    from repro_torch.models import steps

    ref_cfg, cfg = _reduced()
    ref_p, model = _params(ref_cfg, cfg)
    ref_b, b = _both(_batch(rng, cfg, b=8))
    ref_step = jax.jit(ref_steps.make_train_step(
        lambda pp, bb: ref_recsys.loss_fn(ref_cfg, pp, bb), ref_adamw.AdamWConfig(lr=1e-3)))
    p2, _, m_ref = ref_step(ref_p, ref_adamw.init(ref_p), ref_b)
    step = steps.make_train_step(lambda pp, bb: recsys.loss_fn(cfg, pp, bb),
                                 adamw.AdamWConfig(lr=1e-3))
    logit0 = recsys.forward(cfg, model, b)
    assert logit0.shape == (8,) and torch.isfinite(logit0).all()
    m = step(model, adamw.init(list(model.parameters())), b)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]), **GRAD)
    _close(recsys.forward(cfg, model, b).detach(),
           ref_recsys.forward(ref_cfg, p2, ref_b), **GRAD)


@pytest.mark.parametrize("cell_name", ["serve_p99", "retrieval_cand"])
def test_arch_serve_and_retrieve_match_reference(cell_name, rng):
    ref_spec, spec = ref_configs.get("dcn-v2"), configs.get("dcn-v2")
    ref_cfg, cfg = _reduced()
    ref_arch, arch = type(ref_spec)(ref_cfg), base.RecsysArch(cfg)
    ref_cell = dataclasses.replace(ref_arch.cells()[cell_name], batch=4)
    cell = dataclasses.replace(arch.cells()[cell_name], batch=4)
    ref_p, model = _params(ref_cfg, cfg)
    b = _batch(rng, cfg, b=4)
    del b["labels"]
    if cell_name == "retrieval_cand":
        b["candidates"] = rng.normal(size=(300, cfg.mlp[-1])).astype(np.float32)
    ref_b, port_b = _both(b)
    want = ref_arch.step(ref_cell)({"params": ref_p}, ref_b)
    got = arch.step(cell)({"params": model}, port_b)
    if cell_name == "retrieval_cand":
        _close(got[0], want[0], **FWD)
        assert tuple(got[1].shape) == tuple(np.asarray(want[1]).shape)
    else:
        _close(got, want, **FWD)


def test_abstract_state_is_meta_and_matches_reference():
    ref_spec, spec = ref_configs.get("dcn-v2"), configs.get("dcn-v2")
    for name, cell in spec.cells().items():
        ref_state = ref_spec.abstract_state(ref_spec.cells()[name])
        state = spec.abstract_state(cell)
        assert set(state) == set(ref_state)
        model = state["params"]
        assert all(p.device.type == "meta" for p in model.parameters())
        ref_params = ref_state["params"]
        for pname, p in model.named_parameters():
            want = ref_params
            for part in pname.split("."):
                want = want[int(part)] if isinstance(want, list) else want[part]
            assert tuple(p.shape) == want.shape and want.dtype == jnp.float32
        if "opt" in state:
            assert [tuple(t.shape) for t in state["opt"]["mu"]] == [
                tuple(p.shape) for p in model.parameters()]
            assert state["opt"]["step"].dtype == torch.int32
