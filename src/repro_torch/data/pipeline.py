"""Deterministic, shardable host data pipeline.

Determinism contract (fault tolerance): batch ``i`` of epoch ``e`` is a pure
function of ``(seed, e, i, host_shard)`` — a replacement host replays its
shard exactly after restart; no inter-host coordination needed beyond the
step counter in the checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    host_index: int
    host_count: int


def _perm(seed: int, epoch: int, n: int) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(n)


def token_batches(
    corpus: np.ndarray,  # [N] int32 token stream
    *,
    batch: int,
    seq: int,
    seed: int,
    shard: ShardSpec,
    start_step: int = 0,
) -> Iterator[dict]:
    """Next-token LM batches: deterministic sequence of (tokens, labels)."""
    n_seqs = (len(corpus) - 1) // seq
    per_host = batch // shard.host_count
    assert per_host * shard.host_count == batch, "batch % hosts != 0"
    step = start_step
    while True:
        epoch = (step * batch) // max(n_seqs, 1)
        perm = _perm(seed, epoch, n_seqs)
        base = (step * batch) % max(n_seqs, 1)
        idx = perm[(base + np.arange(batch)) % n_seqs]
        idx = idx[shard.host_index * per_host : (shard.host_index + 1) * per_host]
        toks = np.stack([corpus[i * seq : i * seq + seq] for i in idx])
        lbls = np.stack([corpus[i * seq + 1 : i * seq + seq + 1] for i in idx])
        yield {"tokens": toks.astype(np.int32), "labels": lbls.astype(np.int32)}
        step += 1


def synthetic_corpus(vocab: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Zipfian synthetic token stream (offline-friendly LM data)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)


def recsys_batches(
    *,
    batch: int,
    n_dense: int,
    vocab_sizes: tuple[int, ...],
    seed: int,
    shard: ShardSpec,
    start_step: int = 0,
) -> Iterator[dict]:
    per_host = batch // shard.host_count
    step = start_step
    vocabs = np.asarray(vocab_sizes)
    while True:
        rng = np.random.default_rng((seed, step, shard.host_index))
        dense = rng.normal(size=(per_host, n_dense)).astype(np.float32)
        sparse = (rng.random((per_host, len(vocabs))) * vocabs).astype(np.int32)
        logits = dense[:, 0] + 0.1 * (sparse[:, 0] % 7 - 3)
        labels = (logits + rng.normal(size=per_host) > 0).astype(np.float32)
        yield {"dense": dense, "sparse": sparse, "labels": labels}
        step += 1
