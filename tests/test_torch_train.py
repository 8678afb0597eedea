"""The port's training path against the JAX package: AdamW and its
schedule, gradient compression, the train step with and without
microbatches, the data pipeline, checkpoints, and ``launch.train``'s
restart from a checkpoint.

Tolerances: AdamW over 5 steps at rtol 1e-6 (params, moments, ``lr``,
``grad_norm``), with atol 1e-9 for parameters that the step carries
close to zero; compression and the data pipeline exactly; the train step
at rtol 1e-4 (loss, and parameters with atol 1e-4 times the tensor's
largest magnitude); ``launch.train``'s losses after a restart against an
uninterrupted run at rtol 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.data import pipeline as ref_pipeline
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro.optimizer import adamw as ref_adamw
from repro.optimizer import compress as ref_compress
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import steps
from repro_torch.models import transformer as tr
from repro_torch.optimizer import adamw, compress

SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 5, 3)}  # sorted: JAX's leaf order


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])  # clipping on, and off
def test_adamw_matches_reference_over_five_steps(clip_norm):
    rng = np.random.default_rng(0)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm)
    ref_cfg, cfg = ref_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_state = ref_adamw.init(ref_p)
    params = [torch.from_numpy(p0[k].copy()) for k in SHAPES]
    state = adamw.init(params)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        ref_p, ref_state, ref_m = ref_adamw.update(
            ref_cfg, {k: jnp.asarray(v) for k, v in g.items()}, ref_state, ref_p)
        m = adamw.update(cfg, [torch.from_numpy(g[k]) for k in SHAPES], state, params)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]),
                                   rtol=1e-6)
        for i, k in enumerate(SHAPES):
            np.testing.assert_allclose(_np(params[i]), _np(ref_p[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(_np(state["mu"][i]), _np(ref_state["mu"][k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(_np(state["nu"][i]), _np(ref_state["nu"][k]),
                                       rtol=1e-6)
        assert int(state["step"]) == int(ref_state["step"])
        assert state["step"].dtype == torch.int32


def test_schedule_matches_reference():
    cfg_kw = dict(lr=3e-4, warmup_steps=20, total_steps=200, min_lr_frac=0.1)
    ref_cfg, cfg = ref_adamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    for step in (0, 1, 7, 20, 21, 100, 199, 200, 500):
        want = ref_adamw.schedule(ref_cfg, jnp.float32(step))
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    want = ref_adamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = adamw.global_norm([torch.from_numpy(tree[k]) for k in SHAPES])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_keeps_bf16_params_bf16():
    p = [torch.ones(4, dtype=torch.bfloat16)]
    state = adamw.init(p)
    assert state["mu"][0].dtype == torch.float32
    adamw.update(adamw.AdamWConfig(lr=0.1, warmup_steps=1), [torch.ones(4)], state, p)
    assert p[0].dtype == torch.bfloat16 and not torch.equal(p[0], torch.ones(4, dtype=torch.bfloat16))


# --------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fraction", [0.01, 0.2, 1.0])
def test_topk_sparsify_matches_reference(fraction):
    rng = np.random.default_rng(2)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    e = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
    want_kept, want_err = ref_compress.topk_sparsify(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in e.items()}, fraction)
    kept, err = compress.topk_sparsify([torch.from_numpy(g[k]) for k in SHAPES],
                                       [torch.from_numpy(e[k]) for k in SHAPES], fraction)
    for i, k in enumerate(SHAPES):
        np.testing.assert_array_equal(_np(kept[i]), _np(want_kept[k]))
        np.testing.assert_array_equal(_np(err[i]), _np(want_err[k]))


def test_int8_quantization_matches_reference():
    rng = np.random.default_rng(3)
    g = {k: rng.normal(size=s).astype(np.float32) * 3 for k, s in SHAPES.items()}
    want_q, want_s = ref_compress.quantize_int8({k: jnp.asarray(v) for k, v in g.items()})
    q, s = compress.quantize_int8([torch.from_numpy(g[k]) for k in SHAPES])
    deq = compress.dequantize_int8(q, s)
    want_deq = ref_compress.dequantize_int8(want_q, want_s)
    for i, k in enumerate(SHAPES):
        assert q[i].dtype == torch.int8
        np.testing.assert_array_equal(_np(q[i]), _np(want_q[k]))
        np.testing.assert_array_equal(_np(s[i]), _np(want_s[k]))
        np.testing.assert_array_equal(_np(deq[i]), _np(want_deq[k]))
    err = compress.init_error([torch.from_numpy(g[k]) for k in SHAPES])
    assert all(e.dtype == torch.float32 and not e.any() for e in err)


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #
def _tiny():
    kw = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=101, head_dim=16, remat=False)
    return (ref_tr.LMConfig(**kw, dtype=jnp.float32),
            tr.LMConfig(**kw, dtype=torch.float32))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    ref_cfg, cfg = _tiny()
    opt_kw = dict(lr=5e-3, warmup_steps=1, weight_decay=0.1)
    ref_opt, opt = ref_adamw.AdamWConfig(**opt_kw), adamw.AdamWConfig(**opt_kw)
    ref_p = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, ref_p), cfg, device="cpu")
    ref_state = ref_adamw.init(ref_p)
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, ref_state), model)
    ref_step = jax.jit(ref_steps.make_train_step(
        lambda p, b: ref_tr.loss_fn(ref_cfg, p, b), ref_opt, microbatches=microbatches))
    step = steps.make_train_step(lambda p, b: tr.loss_fn(cfg, p, b), opt,
                                 microbatches=microbatches)
    corpus = pipeline.synthetic_corpus(cfg.vocab, 20_000, seed=0)
    batches = pipeline.token_batches(corpus, batch=4, seq=16, seed=1,
                                     shard=pipeline.ShardSpec(0, 1))
    for _ in range(3):
        b = next(batches)
        ref_p, ref_state, ref_m = ref_step(
            ref_p, ref_state, {k: jnp.asarray(v) for k, v in b.items()})
        m = step(model, state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]),
                                   rtol=1e-4)
    tree = jax.tree.map(np.asarray, ref_p)
    for name, p in model.named_parameters():
        want = convert._leaf(tree, name)
        np.testing.assert_allclose(_np(p), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    assert int(state["step"]) == 3


def test_train_step_rejects_an_uneven_split():
    _, cfg = _tiny()
    model = tr.init_params(cfg, 0, device="cpu")
    step = steps.make_train_step(lambda p, b: tr.loss_fn(cfg, p, b),
                                 adamw.AdamWConfig(), microbatches=3)
    toks = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="microbatches"):
        step(model, adamw.init(list(model.parameters())), {"tokens": toks, "labels": toks})


# --------------------------------------------------------------------- #
# the data pipeline
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("host,hosts", [(0, 1), (1, 2)])
@pytest.mark.parametrize("start", [0, 37])
def test_token_batches_bit_equal(host, hosts, start):
    corpus = pipeline.synthetic_corpus(500, 5_000, seed=3)
    assert np.array_equal(corpus, ref_pipeline.synthetic_corpus(500, 5_000, seed=3))
    kw = dict(batch=8, seq=16, seed=5, start_step=start)
    got = pipeline.token_batches(corpus, shard=pipeline.ShardSpec(host, hosts), **kw)
    want = ref_pipeline.token_batches(corpus, shard=ref_pipeline.ShardSpec(host, hosts), **kw)
    for _ in range(50):  # past an epoch boundary (312 sequences, 8 a step)
        a, b = next(got), next(want)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("host,hosts", [(0, 1), (1, 2)])
def test_recsys_batches_bit_equal(host, hosts):
    kw = dict(batch=16, n_dense=13, vocab_sizes=(10, 1000, 7), seed=2, start_step=3)
    got = pipeline.recsys_batches(shard=pipeline.ShardSpec(host, hosts), **kw)
    want = ref_pipeline.recsys_batches(shard=ref_pipeline.ShardSpec(host, hosts), **kw)
    for _ in range(4):
        a, b = next(got), next(want)
        for k in ("dense", "sparse", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# --------------------------------------------------------------------- #
# checkpoints (the port's twins of tests/test_infra.py's cases)
# --------------------------------------------------------------------- #
def _tree(rng):
    return {
        "a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        "nested": {"b": torch.arange(7), "c": [torch.ones(2), torch.zeros(3)]},
        "step": torch.tensor(17, dtype=torch.int32),
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._leaves(tree)]


def test_save_restore_roundtrip(tmp_path, rng):
    t = _tree(rng)
    ckpt.save(str(tmp_path), 5, t)
    like = {"a": torch.zeros(4, 3), "nested": {"b": torch.zeros(7, dtype=torch.int64),
            "c": [torch.zeros(2), torch.zeros(3)]}, "step": torch.tensor(0, dtype=torch.int32)}
    restored, step = ckpt.restore(str(tmp_path), like)
    assert step == 5
    assert isinstance(restored["nested"]["c"], list)
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


def test_uncommitted_checkpoint_ignored(tmp_path, rng):
    t = _tree(rng)
    ckpt.save(str(tmp_path), 1, t)
    # fake a half-written step (no COMMIT)
    os.makedirs(tmp_path / "step_00000002")
    assert ckpt.latest_steps(str(tmp_path)) == [1]


def test_corruption_detected(tmp_path, rng):
    t = _tree(rng)
    ckpt.save(str(tmp_path), 3, t)
    target = next((tmp_path / "step_00000003").glob("a.npy"))
    data = target.read_bytes()
    target.write_bytes(data[:-1] + bytes([data[-1] ^ 1]))
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), t)


def test_background_save_and_gc(tmp_path, rng):
    t = _tree(rng)
    threads = [ckpt.save(str(tmp_path), s, t, background=True, keep=2) for s in range(4)]
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert ckpt.latest_steps(str(tmp_path)) == [2, 3]


def test_background_save_holds_the_values_at_the_call(tmp_path, rng):
    """The host copy is taken before ``save`` returns: an in-place update
    right after it never reaches the checkpoint."""
    t = _tree(rng)
    want = t["a"].clone()
    th = ckpt.save(str(tmp_path), 1, t, background=True)
    t["a"].add_(1.0)
    th.join(timeout=60)
    restored, _ = ckpt.restore(str(tmp_path), t)
    assert torch.equal(restored["a"], want)


def test_port_checkpoint_reads_in_the_reference(tmp_path, rng):
    """Same layout, names, manifest and hashes: the JAX package restores a
    checkpoint the port wrote."""
    t = _tree(rng)
    ckpt.save(str(tmp_path), 4, t)
    like = {"a": jnp.zeros((4, 3)), "nested": {"b": jnp.zeros(7, jnp.int32),
            "c": [jnp.zeros(2), jnp.zeros(3)]}, "step": jnp.int32(0)}
    restored, step = ref_ckpt.restore(str(tmp_path), like)
    assert step == 4
    for a, b in zip(_leaves(t), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# --------------------------------------------------------------------- #
# the training entry point
# --------------------------------------------------------------------- #
ARGS = ["--device", "cpu", "--reduced", "--steps", "12", "--batch", "4", "--seq", "16",
        "--ckpt-every", "5"]


def test_train_resumes_after_injected_failure(tmp_path, capsys):
    attempts = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "a"),
                                  "--inject-failure-at", "7"])
    assert [a.start for a in attempts] == [0, 5]
    first, second = attempts
    assert sorted(first.losses) == list(range(7))
    assert sorted(second.losses) == list(range(5, 12))
    assert second.restore_seconds is not None and len(first.save_seconds) == 1
    assert "[restore] resumed from step 5" in capsys.readouterr().out
    # steps 5 and 6 ran twice, from the same checkpoint and batches; the
    # CPU's BLAS may split a sum another way while a background save runs,
    # so the losses agree to rounding, not bit for bit
    for s in (5, 6):
        np.testing.assert_allclose(second.losses[s], first.losses[s], rtol=1e-5)
    clean = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(clean) == 1 and clean[0].start == 0
    merged = {**first.losses, **second.losses}
    assert sorted(merged) == sorted(clean[0].losses)
    np.testing.assert_allclose([merged[s] for s in sorted(merged)],
                               [clean[0].losses[s] for s in sorted(merged)], rtol=1e-5)
    assert ckpt.latest_steps(str(tmp_path / "a")) == [5, 10, 12]
    assert all(np.isfinite(v) for v in merged.values())


def test_train_resumes_a_finished_run(tmp_path):
    train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--steps", "6"])
    again = train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--steps", "8", "--keep", "1"])
    assert again[0].start == 6 and sorted(again[0].losses) == [6, 7]
    assert ckpt.latest_steps(str(tmp_path)) == [8]


def test_train_bf16_activations(tmp_path):
    attempts = train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--steps", "3",
                                  "--dtype", "bfloat16"])
    assert all(np.isfinite(v) for v in attempts[0].losses.values())


def test_train_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
