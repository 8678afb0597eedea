"""DCN-v2 (Wang et al., arXiv:2008.13535): cross network + deep MLP over
huge sparse embedding tables.

:func:`embedding_bag` is a gather plus ``index_add_`` (sum and mean
modes), as the JAX package's is ``jnp.take`` plus ``jax.ops.segment_sum``;
single-valued categorical features take the nnz = 1 path, one gather.
All 26 tables are one concatenated ``[sum(vocab), d]`` parameter, so one
row-sharded matrix holds every feature's rows; under a logical-axis rule
context the gather is :func:`repro_torch.distributed.ctx.lookup`'s
row-sharded lookup.

Parameters live in a :class:`Recsys` module whose names are the JAX
package's tree paths (``cross.0.w`` is ``tree["cross"][0]["w"]``).

:func:`retrieval_score` handles the 1-vs-1M ``retrieval_cand`` cell as one
batched product (never a loop).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.ctx import lookup

# Criteo-style per-feature vocabulary sizes (26 categorical fields).
CRITEO_VOCABS = (
    1460, 583, 10_131_227, 2_202_608, 305, 24, 12_517, 633, 3, 93_145,
    5_683, 8_351_593, 3_194, 27, 14_992, 5_461_306, 10, 5_652, 2_173, 4,
    7_046_547, 18, 15, 286_181, 105, 142_572,
)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross: int = 3
    mlp: tuple[int, ...] = (1024, 1024, 512)
    vocab_sizes: tuple[int, ...] = CRITEO_VOCABS
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def total_vocab(self) -> int:
        return sum(self.vocab_sizes)

    @property
    def d_interact(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(
            np.int32
        )


# --------------------------------------------------------------------- #
# EmbeddingBag: gather + index_add_
# --------------------------------------------------------------------- #
def embedding_bag(
    table: torch.Tensor,  # [V, d]
    values: torch.Tensor,  # [nnz] int row ids
    segment_ids: torch.Tensor,  # [nnz] int bag ids (sorted or not)
    n_bags: int,
    mode: str = "sum",
) -> torch.Tensor:
    """Gather rows then segment-reduce per bag: the FBGEMM TBE primitive.
    An empty bag is zero in both modes."""
    seg = segment_ids.to(torch.int64)
    rows = lookup(table, values.to(torch.int64))  # [nnz, d]
    agg = rows.new_zeros((n_bags, rows.shape[-1])).index_add_(0, seg, rows)
    if mode == "mean":
        ones = torch.ones((values.shape[0], 1), dtype=rows.dtype, device=rows.device)
        cnt = ones.new_zeros((n_bags, 1)).index_add_(0, seg, ones)
        agg = agg / torch.clamp(cnt, min=1.0)
    return agg


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def _param(shape, cfg: RecsysConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


class Dense(nn.Module):
    def __init__(self, din: int, dout: int, cfg: RecsysConfig, device):
        super().__init__()
        self.w = _param((din, dout), cfg, device)
        self.b = _param((dout,), cfg, device)


class Recsys(nn.Module):
    """The DCN-v2 parameters, uninitialised (``init_params`` draws them;
    ``convert.recsys_params_from_numpy`` copies the JAX package's): the
    concatenated ``table [sum(vocab), d]``, ``n_cross`` full-rank cross
    layers ``[d_interact, d_interact]``, the MLP and the logit head."""

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__()
        d = cfg.d_interact
        self.table = _param((cfg.total_vocab, cfg.embed_dim), cfg, device)
        self.cross = nn.ModuleList(Dense(d, d, cfg, device) for _ in range(cfg.n_cross))
        widths = (d, *cfg.mlp)
        self.mlp = nn.ModuleList(
            Dense(a, b, cfg, device) for a, b in zip(widths[:-1], widths[1:]))
        self.head = Dense(widths[-1], 1, cfg, device)


@torch.no_grad()
def init_params(cfg: RecsysConfig, seed: int = 0, *, device=DEFAULT_DEVICE) -> Recsys:
    """A random model from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, drawn as the JAX package draws it: the table ``normal *
    0.01``, every weight ``normal / sqrt(fan_in)``, biases zero."""
    device = resolve_device(device)
    model = Recsys(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name == "table":
            p.normal_(generator=gen).mul_(0.01)
        elif name.endswith(".b"):
            p.zero_()
        else:
            p.normal_(generator=gen).div_(math.sqrt(p.shape[0]))
    return model


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
def _affine(p, x: torch.Tensor, dtype) -> torch.Tensor:
    return x @ p.w.to(dtype) + p.b.to(dtype)


def _trunk(cfg: RecsysConfig, params: Recsys, batch: dict) -> torch.Tensor:
    """dense + embedded sparse -> cross stack -> deep MLP; returns [B, mlp[-1]]."""
    dense = batch["dense"]
    b = dense.shape[0]
    width = cfg.n_sparse * cfg.embed_dim
    if "bag_values" in batch:
        emb = embedding_bag(
            params.table, batch["bag_values"], batch["bag_segments"],
            n_bags=b * cfg.n_sparse,
        ).reshape(b, width)
    else:
        offs = torch.as_tensor(cfg.offsets(), dtype=torch.int64, device=dense.device)
        idx = batch["sparse"].to(torch.int64) + offs[None, :]  # [B, 26] global rows
        emb = lookup(params.table, idx.reshape(-1)).reshape(b, width)
    x0 = torch.cat([dense.to(cfg.dtype), emb.to(cfg.dtype)], dim=-1)
    x = x0
    for cp in params.cross:  # x_{l+1} = x0 * (W x_l + b) + x_l
        x = x0 * _affine(cp, x, cfg.dtype) + x
    for mp in params.mlp:
        x = F.relu(_affine(mp, x, cfg.dtype))
    return x


def forward(cfg: RecsysConfig, params: Recsys, batch: dict) -> torch.Tensor:
    """CTR logit [B]."""
    return _affine(params.head, _trunk(cfg, params, batch), cfg.dtype)[:, 0]


def loss_fn(cfg: RecsysConfig, params: Recsys, batch: dict) -> torch.Tensor:
    """Mean binary cross entropy with logits, in f32."""
    logit = forward(cfg, params, batch).to(torch.float32)
    y = batch["labels"].to(torch.float32)
    return torch.mean(
        torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit)))
    )


def retrieval_score(
    cfg: RecsysConfig, params: Recsys, batch: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score the queries against N candidates; returns (scores [B, N],
    top-100 indices [B, 100]).

    ``batch['candidates']`` is [N, mlp[-1]] precomputed item vectors; the
    query tower is the DCN trunk.  One [B, d] x [d, N] product.
    """
    q = _trunk(cfg, params, batch)  # [B, d]
    scores = q @ batch["candidates"].to(cfg.dtype).T  # [B, N]
    top = torch.topk(scores, 100, dim=-1).indices
    return scores, top
