"""The port's dense LM against the JAX package, from the same parameters.

JAX's PRNG cannot be reproduced in torch, so each case draws the JAX
package's parameters, hands them over as numpy
(``convert.lm_params_from_numpy``) and feeds both packages the same
tokens.  Tolerances: f32 forward, loss, cross entropy, RoPE, attention
and decode at rtol 1e-5, with atol 1e-5 where values are of unit scale
and one can sit near zero (hidden states after RMSNorm, attention
outputs, logits: two BLAS libraries round their sums differently);
gradients at rtol 1e-4, with atol 1e-4 times the tensor's largest
|gradient| for elements near zero; a bf16 forward at rtol 2e-2, with atol 2e-2 times the largest
|hidden| (bf16 keeps 8 bits of mantissa, and the two packages round
their bf16 intermediates in different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tr
from repro_torch import convert
from repro_torch.models import transformer as tr

F32 = dict(rtol=1e-5, atol=1e-5)


def _tiny(window=None, qk_norm=False, moe=False):
    """``tests/test_models_lm.py``'s tiny config, in both packages."""
    kw = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=101, head_dim=16, qk_norm=qk_norm,
              sliding_window=window, remat=False)
    ref_cfg = ref_tr.LMConfig(
        **kw, dtype=jnp.float32,
        moe=ref_tr.MoEConfig(n_experts=4, top_k=2, d_expert=32, capacity_factor=4.0)
        if moe else None,
    )
    cfg = tr.LMConfig(
        **kw, dtype=torch.float32,
        moe=tr.MoEConfig(n_experts=4, top_k=2, d_expert=32, capacity_factor=4.0)
        if moe else None,
    )
    return ref_cfg, cfg


def _params(ref_cfg, cfg, seed=0):
    ref_p = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, ref_p)
    return ref_p, convert.lm_params_from_numpy(tree, cfg, device="cpu")


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_forward_matches_reference(window, qk_norm):
    ref_cfg, cfg = _tiny(window=window, qk_norm=qk_norm)
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, 24), cfg.vocab)
    want, _ = ref_tr.forward(ref_cfg, ref_p, jnp.asarray(toks))
    got, aux = tr.forward(cfg, model, torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_loss_matches_reference(window, qk_norm):
    ref_cfg, cfg = _tiny(window=window, qk_norm=qk_norm)
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, 24), cfg.vocab)
    labels = _tokens((2, 24), cfg.vocab, seed=2)
    labels[0, :5] = -1  # masked labels count nowhere
    want = ref_tr.loss_fn(ref_cfg, ref_p, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)})
    got = tr.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


@pytest.mark.parametrize("seq", [32, 29])  # a whole number of chunks, and a padded one
def test_chunked_ce_matches_reference(seq):
    ref_cfg, cfg = _tiny()
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, seq), cfg.vocab)
    hidden = np.random.default_rng(3).normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    want = ref_tr.chunked_ce(ref_cfg, ref_p, jnp.asarray(hidden), jnp.asarray(toks), chunk=8)
    got = tr.chunked_ce(cfg, model, torch.from_numpy(hidden), torch.from_numpy(toks),
                        chunk=8).detach()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # and against the direct log-softmax of the whole logits
    logits = tr.logits_of(cfg, model, torch.from_numpy(hidden))
    direct = -torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(toks).long()[..., None]).mean()
    np.testing.assert_allclose(float(got), float(direct.detach()), rtol=1e-5)


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 7))).astype(np.int32)
    want = ref_tr.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tr.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def _qkv(b, sq, sk, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("sq,sk,offset", [(40, 40, 0), (33, 50, 17), (1, 9, 8)])
def test_chunked_attention_matches_reference_and_one_block(window, sq, sk, offset):
    """Small chunks force the online-softmax branch (padded queries and
    keys, fully masked key chunks) in both packages; the one-block branch
    must agree with it."""
    q, k, v = _qkv(2, sq, sk, 4, 2, 16)
    q_pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + offset, (2, sq)).copy()
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (2, sk)).copy()
    args_j = [jnp.asarray(a) for a in (q, k, v, q_pos, k_pos)]
    args_t = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    small = dict(chunk_q=4, chunk_k=8)
    if sq * sk <= 4 * 8 * 4:
        small = dict(chunk_q=1, chunk_k=2)
    want = ref_tr.gqa_attention(*args_j, window=window, **small)
    got = tr.gqa_attention(*args_t, window=window, **small)
    one = tr.gqa_attention(*args_t, window=window)
    want_one = ref_tr.gqa_attention(*args_j, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(one), _np(want_one), **F32)
    np.testing.assert_allclose(_np(got), _np(one), **F32)


def test_fully_masked_rows_give_zero():
    """A query whose every key is masked (the sliding window past all keys)
    gets p = 0 everywhere, so its output is 0, not a mean of the values."""
    q, k, v = _qkv(1, 2, 4, 2, 1, 8)
    q_pos = np.asarray([[100, 101]], np.int32)
    k_pos = np.arange(4, dtype=np.int32)[None]
    args = [torch.from_numpy(a) for a in (q, k, v, q_pos, k_pos)]
    for chunks in ({}, dict(chunk_q=1, chunk_k=2)):
        out = tr.gqa_attention(*args, window=8, **chunks)
        assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_decode_matches_reference(window):
    ref_cfg, cfg = _tiny(window=window)
    ref_p, model = _params(ref_cfg, cfg)
    s = 16
    toks = _tokens((2, s + 1), cfg.vocab, seed=2)
    want_last, want_cache = ref_tr.prefill_step(ref_cfg, ref_p, jnp.asarray(toks[:, :s]))
    got_last, cache = tr.prefill_step(cfg, model, torch.from_numpy(toks[:, :s]))
    np.testing.assert_allclose(_np(got_last), _np(want_last), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(want_cache[key]), **F32)
    assert np.array_equal(_np(cache["pos"]), _np(want_cache["pos"]))
    want_dec, want_c2 = ref_tr.decode_step(ref_cfg, ref_p, want_cache,
                                           jnp.asarray(toks[:, s:s + 1]))
    got_dec, c2 = tr.decode_step(cfg, model, cache, torch.from_numpy(toks[:, s:s + 1]))
    np.testing.assert_allclose(_np(got_dec), _np(want_dec), **F32)
    assert int(c2["pos"][0]) == int(cache["pos"][0]) + 1
    assert c2["k"].shape == cache["k"].shape
    # decode reproduces the teacher-forced logits at position s
    hidden, _ = tr.forward(cfg, model, torch.from_numpy(toks))
    full = tr.logits_of(cfg, model, hidden)[:, s]
    np.testing.assert_allclose(_np(got_dec[:, 0]), _np(full), atol=2e-4)


def test_kv_cache_shapes():
    _, cfg = _tiny(window=8)
    cache = tr.init_kv_cache(cfg, batch=2, seq=1000, device="cpu")
    assert cache["k"].shape == (2, 2, 8, 2, 16)
    assert int(cache["pos"][0]) == 8


@pytest.mark.parametrize("qk_norm", [False, True])
def test_grads_match_reference(qk_norm):
    ref_cfg, cfg = _tiny(qk_norm=qk_norm)
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, 24), cfg.vocab)
    labels = _tokens((2, 24), cfg.vocab, seed=4)
    ref_g = jax.grad(lambda p: ref_tr.loss_fn(
        ref_cfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}))(ref_p)
    loss = tr.loss_fn(cfg, model, {"tokens": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    tree = jax.tree.map(np.asarray, ref_g)
    for name, g in zip(names, grads):
        want = convert._leaf(tree, name)
        np.testing.assert_allclose(_np(g), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_remat_gives_the_same_loss_and_grads():
    _, cfg = _tiny()
    model = tr.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens((2, 16), cfg.vocab))
    batch = {"tokens": toks, "labels": toks}
    out = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        loss = tr.loss_fn(c, model, batch)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_forward_matches_reference():
    ref_cfg, cfg = _tiny()
    ref_cfg = dataclasses.replace(ref_cfg, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    ref_p, model = _params(ref_cfg, cfg)
    toks = _tokens((2, 24), cfg.vocab)
    want, _ = ref_tr.forward(ref_cfg, ref_tr.cast_params(ref_cfg, ref_p), jnp.asarray(toks))
    got, _ = tr.forward(cfg, tr.cast_params(cfg, model), torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_init_params_scale_and_seed():
    _, cfg = _tiny()
    a = tr.init_params(cfg, 0, device="cpu")
    b = tr.init_params(cfg, 0, device="cpu")
    c = tr.init_params(cfg, 1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert len(a.layers) == cfg.n_layers
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    # normal / sqrt(fan_in): w_down's fan-in is d_ff
    std = float(a.layers[0].mlp.w_down.std())
    assert abs(std * np.sqrt(cfg.d_ff) - 1.0) < 0.1
    assert torch.equal(a.ln_f, torch.ones(cfg.d_model))


def test_moe_config_raises():
    """An MoE config and a dense parameter tree do not mix: converting the
    JAX package's dense tree for an MoE config, or its MoE tree for a
    dense config, raises and names the missing leaf."""
    ref_dense, dense = _tiny()
    ref_moe, moe = _tiny(moe=True)
    for ref_cfg, cfg, missing in ((ref_dense, moe, "moe"), (ref_moe, dense, "mlp")):
        tree = jax.tree.map(np.asarray, ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0)))
        with pytest.raises(ValueError, match=missing):
            convert.lm_params_from_numpy(tree, cfg, device="cpu")
    assert tr.init_params(moe, 0, device="cpu").layers[0].moe.w_gate.shape == (4, 64, 32)


def test_entry_points_default_to_the_card():
    _, cfg = _tiny()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.init_params(cfg, 0)
