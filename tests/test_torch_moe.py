"""The port's MoE LM against the JAX package, from the same parameters.

Each case draws the JAX package's parameters, hands them over as numpy
(``convert.lm_params_from_numpy``) and feeds both packages the same inputs.
The dispatch (the experts of the sorted ``(token, k)`` slots, their
positions and the dropped set) is discrete and must be equal exactly; the
JAX package computes it inside ``moe_block``, so the test recomputes it
with the same ``jnp`` calls (``_ref_dispatch``).  Tolerances: ``moe_block``
output and aux at f32 rtol 1e-5, atol 1e-5 (two BLAS libraries round the
expert products' sums differently); the reduced MoE LMs' forward and loss
at rtol 1e-5 with atol 1e-5, gradients and the train step at rtol 1e-4
with atol 1e-4 times the tensor's largest magnitude, as the dense LM's
parity tests hold them.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro.optimizer import adamw as ref_adamw
from repro_torch import configs, convert
from repro_torch.checkpoint import ckpt
from repro_torch.data import pipeline
from repro_torch.distributed import ctx
from repro_torch.models import steps
from repro_torch.models import transformer as tr
from repro_torch.optimizer import adamw

F32 = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reduced(arch, **moe):
    """The arch's ``reduced()`` config in both packages (E = 4, top-2,
    d_expert 32), with ``moe`` fields replaced."""
    ref_cfg = ref_configs.get(arch).reduced()
    cfg = configs.get(arch).reduced()
    return (dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)))


def _params(ref_cfg, cfg, seed=0):
    ref_p = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return ref_p, convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg,
                                               device="cpu")


def _moe_inputs(ref_cfg, cfg, shape=(4, 16), seed=3):
    """One layer's MoE parameters in both packages and an input [B, S, d]."""
    ref_p, model = _params(ref_cfg, cfg)
    ref_moe = jax.tree.map(lambda a: a[0], ref_p["layers"]["moe"])
    x = np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)).astype(np.float32)
    return ref_moe, model.layers[0].moe, x


def _ref_dispatch(ref_cfg, router, xg):
    """The JAX package's ``moe_block`` dispatch (transformer.py's router,
    stable sort, bincount prefix and capacity), with the same ``jnp`` calls."""
    m = ref_cfg.moe
    g_, tl, _ = xg.shape
    k, e = m.top_k, m.n_experts
    tkl = tl * k
    probs = jax.nn.softmax((xg @ router.astype(jnp.float32)).astype(jnp.float32), -1)
    _, topi = jax.lax.top_k(probs, k)
    e_flat = topi.reshape(g_, tkl)
    tok_flat = jnp.broadcast_to(jnp.arange(tkl, dtype=jnp.int32) // k, (g_, tkl))
    order = jnp.argsort(e_flat, axis=-1, stable=True)
    e_s = jnp.take_along_axis(e_flat, order, -1)
    tok_s = jnp.take_along_axis(tok_flat, order, -1)
    counts = jax.vmap(lambda es: jnp.bincount(es, length=e))(e_s)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(tkl, dtype=jnp.int32)[None] - jnp.take_along_axis(starts, e_s, -1)
    cap = max(int(math.ceil(tl * k / e * m.capacity_factor)), k)
    return np.asarray(e_s), np.asarray(tok_s), np.asarray(pos), np.asarray(counts), cap


# --------------------------------------------------------------------- #
# moe_block
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
@pytest.mark.parametrize("groups", [1, 2])
def test_dispatch_matches_reference_exactly(arch, capacity_factor, groups):
    ref_cfg, cfg = _reduced(arch, capacity_factor=capacity_factor)
    ref_moe, moe, x = _moe_inputs(ref_cfg, cfg)
    xg = x.reshape(groups, -1, cfg.d_model)
    e_s, tok_s, pos, counts, cap = _ref_dispatch(ref_cfg, ref_moe["router"], jnp.asarray(xg))
    _, disp = tr.route(cfg, moe.router, torch.from_numpy(xg))
    assert disp.cap == cap
    np.testing.assert_array_equal(_np(disp.expert), e_s)
    np.testing.assert_array_equal(_np(disp.token), tok_s)
    np.testing.assert_array_equal(_np(disp.pos), pos)
    np.testing.assert_array_equal(_np(disp.counts), counts)
    np.testing.assert_array_equal(_np(disp.kept), pos < cap)  # the dropped set
    if capacity_factor == 1.0:
        assert not bool(disp.kept.all()), "capacity 1.0 should drop slots here"


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
@pytest.mark.parametrize("groups", [None, 2])
def test_moe_block_matches_reference(arch, capacity_factor, groups):
    ref_cfg, cfg = _reduced(arch, capacity_factor=capacity_factor)
    ref_moe, moe, x = _moe_inputs(ref_cfg, cfg)
    want, want_aux = ref_tr.moe_block(ref_cfg, ref_moe, jnp.asarray(x), groups=groups)
    got, aux = tr.moe_block(cfg, moe, torch.from_numpy(x), groups=groups)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(aux), _np(want_aux), **F32)


def test_dropped_slot_contributes_nothing():
    """With capacity 1.0 a token whose every slot is dropped gets a zero
    output, and a token with some dropped slots only its kept experts'."""
    _, cfg = _reduced("olmoe-1b-7b", capacity_factor=1.0)
    model = tr.init_params(cfg, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 64, cfg.d_model))
                         .astype(np.float32))
    y, _ = tr.moe_block(cfg, model.layers[0].moe, x)
    _, disp = tr.route(cfg, model.layers[0].moe.router, x.reshape(1, 64, -1))
    kept_per_token = torch.zeros(64, dtype=torch.int64).index_add_(
        0, disp.token[0], disp.kept[0].to(torch.int64))
    assert bool((kept_per_token < cfg.moe.top_k).any())
    dead = kept_per_token == 0
    assert torch.equal(y[0][dead], torch.zeros_like(y[0][dead]))
    assert bool(y[0][~dead].abs().sum(-1).gt(0).all())


def test_group_count_outside_a_rule_context_is_one():
    assert ctx.group_count("batch", 64) == 1
    assert ctx.group_count("expert", 7) == 1


# --------------------------------------------------------------------- #
# the reduced MoE LMs
# --------------------------------------------------------------------- #
def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_aux_match_reference(arch):
    ref_cfg, cfg = _reduced(arch)
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, 24), cfg.vocab)
    want, want_aux = ref_tr.forward(ref_cfg, ref_p, jnp.asarray(toks))
    got, aux = tr.forward(cfg, model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(aux), _np(want_aux), **F32)
    assert float(aux.detach()) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
def test_loss_and_grads_match_reference(arch, capacity_factor):
    ref_cfg, cfg = _reduced(arch, capacity_factor=capacity_factor)
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, 24), cfg.vocab)
    labels = _tokens((2, 24), cfg.vocab, seed=4)
    labels[1, :3] = -1
    ref_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want, ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_tr.loss_fn(ref_cfg, p, ref_batch)))(ref_p)
    loss = tr.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss.detach()), float(want), **F32)
    names = [n for n, _ in model.named_parameters()]
    assert any(".moe." in n for n in names)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    tree = jax.tree.map(np.asarray, ref_g)
    for name, g in zip(names, grads):
        want_g = convert._leaf(tree, name)
        np.testing.assert_allclose(_np(g), want_g, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_g).max(), err_msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(arch):
    """One step: loss and grad norm at rtol 1e-4; every parameter whose
    gradient is zero or above 100x AdamW's eps at rtol 1e-4 (atol 1e-4 x
    the tensor's largest magnitude).  Between the two, AdamW's first step
    ``g / (|g| + eps)`` turns the gradient's f32 rounding (~1e-8 here)
    into a step of up to ``lr``, so those few elements are held to the
    step's bound, ``|p' - p| <= lr * (1 + wd * |p|)``, and counted."""
    ref_cfg, cfg = _reduced(arch)
    opt_kw = dict(lr=5e-3, warmup_steps=1, weight_decay=0.1)
    ref_opt, opt = ref_adamw.AdamWConfig(**opt_kw), adamw.AdamWConfig(**opt_kw)
    ref_p, model = _params(ref_cfg, cfg)
    before = [p.detach().clone() for p in model.parameters()]
    ref_state = ref_adamw.init(ref_p)
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, ref_state), model)
    corpus = pipeline.synthetic_corpus(cfg.vocab, 20_000, seed=0)
    b = next(pipeline.token_batches(corpus, batch=4, seq=16, seed=1,
                                    shard=pipeline.ShardSpec(0, 1)))
    ref_b = {k: jnp.asarray(v) for k, v in b.items()}
    ref_g = jax.jit(jax.grad(lambda p: ref_tr.loss_fn(ref_cfg, p, ref_b)))(ref_p)
    ref_p, ref_state, ref_m = jax.jit(ref_steps.make_train_step(
        lambda p, bb: ref_tr.loss_fn(ref_cfg, p, bb), ref_opt))(ref_p, ref_state, ref_b)
    m = steps.make_train_step(lambda p, bb: tr.loss_fn(cfg, p, bb), opt)(
        model, state, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-4)
    tree, grads = jax.tree.map(np.asarray, ref_p), jax.tree.map(np.asarray, ref_g)
    lr, n_small, n = float(ref_m["lr"]), 0, 0
    for (name, p), p0 in zip(model.named_parameters(), before):
        want, g, got, p0 = convert._leaf(tree, name), convert._leaf(grads, name), _np(p), _np(p0)
        well = (np.abs(g) > 100 * ref_opt.eps) | (g == 0)  # a zero gradient: decay alone
        np.testing.assert_allclose(got[well], want[well], rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
        bound = lr * (1 + opt.weight_decay * np.abs(p0[~well])) * (1 + 1e-4)
        assert (np.abs(got[~well] - p0[~well]) <= bound).all(), name
        n_small, n = n_small + int((~well).sum()), n + got.size
    assert n_small < 1e-2 * n


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_reference_and_forward(arch):
    ref_cfg, cfg = _reduced(arch)
    ref_p, model = _params(ref_cfg, cfg)
    s = 16
    toks = _tokens((2, s + 1), cfg.vocab, seed=2)
    want_last, want_cache = ref_tr.prefill_step(ref_cfg, ref_p, jnp.asarray(toks[:, :s]))
    got_last, cache = tr.prefill_step(cfg, model, torch.from_numpy(toks[:, :s]))
    np.testing.assert_allclose(_np(got_last), _np(want_last), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(want_cache[key]), **F32)
    want_dec, _ = ref_tr.decode_step(ref_cfg, ref_p, want_cache, jnp.asarray(toks[:, s:]))
    got_dec, c2 = tr.decode_step(cfg, model, cache, torch.from_numpy(toks[:, s:]))
    np.testing.assert_allclose(_np(got_dec), _np(want_dec), **F32)
    assert c2["k"].shape == cache["k"].shape  # window-sized for mixtral
    # decode reproduces the teacher-forced logits at position s: the MoE
    # routes a token alone as it does within the sequence (no drops at a
    # capacity factor of 4)
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    _, cache = tr.prefill_step(roomy, model, torch.from_numpy(toks[:, :s]))
    got_dec, _ = tr.decode_step(roomy, model, cache, torch.from_numpy(toks[:, s:]))
    hidden, _ = tr.forward(roomy, model, torch.from_numpy(toks))
    full = tr.logits_of(roomy, model, hidden)[:, s]
    np.testing.assert_allclose(_np(got_dec[:, 0]), _np(full), atol=2e-4)


def test_moe_capacity_drop_is_bounded():
    """With capacity_factor=1.0 overflow tokens are dropped, never NaN."""
    _, cfg = _reduced("olmoe-1b-7b", capacity_factor=1.0)
    model = tr.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens((4, 32), cfg.vocab))
    loss = tr.loss_fn(cfg, model, {"tokens": toks, "labels": toks})
    assert np.isfinite(float(loss))
    hidden = model.embed[toks.long()]
    _, disp = tr.route(cfg, model.layers[0].moe.router, hidden.reshape(1, -1, cfg.d_model))
    assert not bool(disp.kept.all())


def test_init_params_draws_the_expert_stacks():
    """3-D expert weights get ``normal / sqrt(fan_in)``: ``d`` for gate and
    up, ``d_expert`` for down; the counts match ``param_count``."""
    cfg = dataclasses.replace(configs.get("olmoe-1b-7b").reduced(), d_model=256,
                              moe=tr.MoEConfig(n_experts=8, top_k=2, d_expert=512))
    model = tr.init_params(cfg, 0, device="cpu")
    moe = model.layers[0].moe
    assert moe.w_gate.shape == (8, 256, 512) and moe.w_down.shape == (8, 512, 256)
    for w, fan_in in ((moe.w_gate, 256), (moe.w_up, 256), (moe.w_down, 512),
                      (moe.router, 256)):
        assert abs(float(w.std()) * math.sqrt(fan_in) - 1.0) < 0.05
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert cfg.active_param_count() < cfg.param_count()


# --------------------------------------------------------------------- #
# conversion and checkpoints with moe leaves
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_and_adamw_state_round_trip(arch):
    ref_cfg, cfg = _reduced(arch)
    ref_p, model = _params(ref_cfg, cfg)
    tree = jax.tree.map(np.asarray, ref_p)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(_np(p), convert._leaf(tree, name), err_msg=name)
    ref_state = ref_adamw.init(ref_p)
    ref_state = {"mu": jax.tree.map(lambda a: a + 1.0, ref_state["mu"]),
                 "nu": jax.tree.map(lambda a: a + 2.0, ref_state["nu"]),
                 "step": jnp.int32(7)}
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, ref_state), model)
    names = [n for n, _ in model.named_parameters()]
    for key, add in (("mu", 1.0), ("nu", 2.0)):
        for name, mom, p in zip(names, state[key], model.parameters()):
            assert mom.shape == p.shape and bool(mom.eq(add).all()), name
    assert int(state["step"]) == 7


def test_checkpoint_save_restore_of_a_moe_state(tmp_path):
    _, cfg = _reduced("mixtral-8x7b")
    model = tr.init_params(cfg, 3, device="cpu")
    state = adamw.init(list(model.parameters()))
    step = steps.make_train_step(lambda p, b: tr.loss_fn(cfg, p, b), adamw.AdamWConfig())
    toks = torch.from_numpy(_tokens((2, 16), cfg.vocab))
    step(model, state, {"tokens": toks, "labels": toks})
    tree = {"params": dict(model.named_parameters()), "opt": state}
    ckpt.save(str(tmp_path), 1, tree)
    fresh = tr.init_params(cfg, 4, device="cpu")
    like = {"params": dict(fresh.named_parameters()),
            "opt": adamw.init(list(fresh.parameters()))}
    restored, at = ckpt.restore(str(tmp_path), like)
    assert at == 1
    assert any(".moe.w_down" in n for n in restored["params"])
    for (_, a), (_, b) in zip(ckpt._leaves(tree), ckpt._leaves(restored)):
        assert torch.equal(a.detach(), b.detach())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_train_runs_the_moe_lm_and_resumes(tmp_path, arch):
    """``launch.train`` takes an MoE LM through the same loop: it restarts
    from its checkpoint after an injected failure and replays the same
    losses; a GNN is not one of its ``--arch`` choices."""
    from repro_torch.launch import train

    args = ["--device", "cpu", "--arch", arch, "--reduced", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    first, second = train.main(args + ["--inject-failure-at", "4"])
    assert second.start == 3 and sorted({**first.losses, **second.losses}) == list(range(6))
    np.testing.assert_allclose(second.losses[3], first.losses[3], rtol=1e-5)
    assert all(np.isfinite(v) for v in second.losses.values())
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--arch", "gatedgcn", "--ckpt-dir", str(tmp_path)])
