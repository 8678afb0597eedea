"""GNN zoo: GatedGCN, GAT, PNA, SchNet — segment-op message passing.

The JAX package's message passing, in plain torch over explicit edge-index
arrays: a segment sum is ``index_add_``, a segment max or min
``scatter_reduce`` (``amax`` / ``amin``, ``include_self=False``), as the
JAX package computes them with ``jax.ops.segment_sum`` / ``segment_max``
in XLA and not with a Pallas kernel.

Graph batch format (all four shapes lower to it):

* ``feat``      — [N, F] node features (or int atom types for molecules)
* ``edges``     — [E, 2] int (src, dst)
* ``edge_mask`` — [E] bool (padding for sampled subgraphs)
* ``labels``    — [N] int (node tasks) or [G] float (graph regression)
* ``node_graph``— [N] int graph id (batched small graphs), else zeros
* ``positions`` — [N, 3] float (SchNet; synthesized for non-geometric cells)
* ``n_graphs``  — int, graph regression only

Parameters live in one ``nn.Module`` per architecture (:class:`GatedGCN`,
:class:`GAT`, :class:`PNA`, :class:`SchNet`) whose parameter names are the
JAX package's tree paths (``layers.0.A.w`` is ``tree["layers"][0]["A"]["w"]``).
Mixed dtypes promote as in JAX: a bf16 activation times an f32 weight is
an f32 product, so only GatedGCN, which casts its weights, runs its layers
in the activation dtype.

The reference's ``constrain`` sites mark node and edge tensors; outside a
rule context they do nothing.  On DTensors (the dry-run) a gather by
edge endpoints reads a replicated node tensor (:func:`_at`) and a segment
reduction is each edge shard's partial result
(:func:`repro_torch.distributed.ctx.segment_reduce`), which the next
``constrain`` reduces onto the node shards.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.ctx import constrain, segment_reduce
from repro_torch.models.transformer import cast_params


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # gatedgcn | gat | pna | schnet
    n_layers: int
    d_hidden: int
    d_in: int
    n_out: int
    n_heads: int = 1
    task: str = "node_class"  # node_class | graph_reg
    # schnet
    n_rbf: int = 300
    cutoff: float = 10.0
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    remat: bool = True  # checkpoint each message-passing layer


def _layer(cfg: GNNConfig, fn):
    """Per-layer remat wrapper: edge-sized intermediates are recomputed in
    the backward pass instead of stored (O(E·d) x n_layers -> O(E·d))."""
    if not cfg.remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


# --------------------------------------------------------------------- #
# segment utilities
# --------------------------------------------------------------------- #
def _index_like(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``idx [E]`` broadcast over the trailing axes of ``vals [E, ...]``."""
    return idx.to(torch.int64).reshape(-1, *([1] * (vals.dim() - 1))).expand_as(vals)


def _sharded(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def _at(x, idx):
    """``x[idx]``: node rows gathered by edge endpoints.  On DTensors the
    node tensor is replicated first (an all-gather of the node features,
    the reference's layout for segment ops), so the gather is local to each
    edge shard and its backward a partial sum."""
    if _sharded(x, idx):
        x = constrain(x, *([None] * x.dim()))
    return x[idx]


def seg_sum(vals, idx, n):
    if _sharded(vals, idx):  # each edge shard's partial sum
        return segment_reduce(vals, idx, n, "sum")
    return vals.new_zeros((n, *vals.shape[1:])).index_add_(0, idx, vals)


def _seg_extreme(vals, idx, n, reduce: str):
    """Segment max or min; a segment with no element gives 0 (as the JAX
    package's ``where(isfinite(out), out, 0)`` turns its ±inf into 0)."""
    if _sharded(vals, idx):  # each edge shard's partial max / min
        out = constrain(segment_reduce(vals, idx, n, reduce), "nodes",
                        *([None] * (vals.dim() - 1)))
    else:
        out = vals.new_zeros((n, *vals.shape[1:])).scatter_reduce(
            0, _index_like(idx, vals), vals, reduce, include_self=False)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def seg_max(vals, idx, n):
    return _seg_extreme(vals, idx, n, "amax")


def seg_min(vals, idx, n):
    return _seg_extreme(vals, idx, n, "amin")


def seg_mean(vals, idx, n, deg=None):
    s = seg_sum(vals, idx, n)
    if deg is None:
        deg = seg_sum(torch.ones((vals.shape[0], 1), dtype=vals.dtype,
                                 device=vals.device), idx, n)
    return s / torch.clamp(deg, min=1.0)


def seg_softmax(logits, idx, n):
    """Softmax over segments (edge -> destination-node groups)."""
    m = seg_max(logits, idx, n)
    e = torch.exp(logits - _at(m, idx))
    z = constrain(seg_sum(e, idx, n), "nodes", None)
    return e / torch.clamp(_at(z, idx), min=1e-30)


# the most elements of one chunk of an [E, H, D] edge tensor that GAT's
# aggregation materialises at a time (1 GiB in f32)
EDGE_CHUNK = 1 << 28


class _WeightedGatherScatter(torch.autograd.Function):
    """``seg_sum(alpha[:, :, None] * hw[src], dst, n)`` over edge chunks of
    at most :data:`EDGE_CHUNK` elements, forward and backward, so the
    ``[E, H, D]`` product is never whole: at ogbn-products' 61.9M edges
    and 8 x 8 heads it is 15.8 GB in f32.  The same sums as the plain
    formula (the backward is the gather's scatter and the product's rule)."""

    @staticmethod
    def forward(ctx, alpha, hw, src, dst, n):
        out = hw.new_zeros((n, *hw.shape[1:]))
        ctx.step = max(1, EDGE_CHUNK // max(1, hw[0].numel()))
        for lo in range(0, src.shape[0], ctx.step):
            sl = slice(lo, lo + ctx.step)
            out.index_add_(0, dst[sl], alpha[sl, :, None] * hw[src[sl]])
        ctx.save_for_backward(alpha, hw, src, dst)
        return out

    @staticmethod
    def backward(ctx, grad):
        alpha, hw, src, dst = ctx.saved_tensors
        g_alpha = torch.empty_like(alpha) if ctx.needs_input_grad[0] else None
        g_hw = torch.zeros_like(hw) if ctx.needs_input_grad[1] else None
        for lo in range(0, src.shape[0], ctx.step):
            sl = slice(lo, lo + ctx.step)
            g = grad[dst[sl]]
            if g_alpha is not None:
                g_alpha[sl] = torch.sum(g * hw[src[sl]], dim=-1)
            if g_hw is not None:
                g_hw.index_add_(0, src[sl], g * alpha[sl, :, None])
        return g_alpha, g_hw, None, None, None


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The tensors in their common dtype, as JAX promotes mixed operands."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def _apply(p, x):
    x, w, b = _promoted(x, p.w, p.b)
    return x @ w + b


def _einsum(eq: str, a, b):
    return torch.einsum(eq, *_promoted(a, b))


def _ln(x, eps=1e-5):
    m = torch.mean(x, dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + eps)


def _linspace(stop: float, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)``'s values: ``stop * i / (num - 1)``
    with the step rounded in ``dtype`` first, the last point ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    return torch.cat([stop * step, torch.full((1,), stop, dtype=dtype, device=device)])


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def _param(shape, cfg: GNNConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


class Dense(nn.Module):
    def __init__(self, din: int, dout: int, cfg: GNNConfig, device):
        super().__init__()
        self.w = _param((din, dout), cfg, device)
        self.b = _param((dout,), cfg, device)


class _Named(nn.Module):
    """A module of named :class:`Dense` children."""

    def __init__(self, dims: dict[str, tuple[int, int]], cfg: GNNConfig, device):
        super().__init__()
        for name, (din, dout) in dims.items():
            setattr(self, name, Dense(din, dout, cfg, device))


class GatedGCN(nn.Module):
    """GatedGCN (Bresson & Laurent; arXiv:2003.00982 benchmark config)."""

    def __init__(self, cfg: GNNConfig, device):
        super().__init__()
        d = cfg.d_hidden
        self.embed = Dense(cfg.d_in, d, cfg, device)
        self.edge_embed = _param((1, d), cfg, device)
        self.layers = nn.ModuleList(
            _Named({k: (d, d) for k in "ABCDE"}, cfg, device) for _ in range(cfg.n_layers))
        self.head = Dense(d, cfg.n_out, cfg, device)


class GATLayer(nn.Module):
    def __init__(self, din: int, heads: int, dout: int, cfg: GNNConfig, device):
        super().__init__()
        self.W = _param((din, heads, dout), cfg, device)
        self.a_src = _param((heads, dout), cfg, device)
        self.a_dst = _param((heads, dout), cfg, device)


class GAT(nn.Module):
    """GAT (Velickovic et al.; Cora config: 2 layers, 8 heads x 8)."""

    def __init__(self, cfg: GNNConfig, device):
        super().__init__()
        layers, din = [], cfg.d_in
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            heads = 1 if last else cfg.n_heads
            dout = cfg.n_out if last else cfg.d_hidden
            layers.append(GATLayer(din, heads, dout, cfg, device))
            din = heads * dout
        self.layers = nn.ModuleList(layers)


class PNA(nn.Module):
    """PNA (Corso et al.; mean/max/min/std x identity/amplification/attenuation)."""

    def __init__(self, cfg: GNNConfig, device):
        super().__init__()
        d = cfg.d_hidden
        self.embed = Dense(cfg.d_in, d, cfg, device)
        self.layers = nn.ModuleList(
            _Named({"pre": (2 * d, d), "post": (13 * d, d)}, cfg, device)
            for _ in range(cfg.n_layers))
        self.head = Dense(d, cfg.n_out, cfg, device)


class SchNet(nn.Module):
    """SchNet (Schütt et al.; continuous-filter conv, rbf=300, cutoff=10)."""

    def __init__(self, cfg: GNNConfig, device):
        super().__init__()
        d = cfg.d_hidden
        self.embed = _param((100, d), cfg, device)
        self.layers = nn.ModuleList(
            _Named({"filt1": (cfg.n_rbf, d), "filt2": (d, d), "lin1": (d, d),
                    "lin2": (d, d)}, cfg, device)
            for _ in range(cfg.n_layers))
        self.out1 = Dense(d, d // 2, cfg, device)
        self.out2 = Dense(d // 2, cfg.n_out, cfg, device)


MODULES = {"gatedgcn": GatedGCN, "gat": GAT, "pna": PNA, "schnet": SchNet}


@torch.no_grad()
def init_params(cfg: GNNConfig, seed: int = 0, *, device=DEFAULT_DEVICE) -> nn.Module:
    """A random model from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, drawn as the JAX package draws it: every weight ``normal /
    sqrt(fan_in)`` (``[fan_in, ...]``; GAT's attention vectors ``[H, D]``
    over ``sqrt(D)``), biases and GatedGCN's edge embedding zero, SchNet's
    atom-type embedding ``normal * 0.1``."""
    device = resolve_device(device)
    model = MODULES[cfg.arch](cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("b", "edge_embed"):
            p.zero_()
        elif name == "embed":  # schnet's atom types
            p.normal_(generator=gen).mul_(0.1)
        elif leaf in ("a_src", "a_dst"):
            p.normal_(generator=gen).div_(math.sqrt(p.shape[1]))
        else:
            p.normal_(generator=gen).div_(math.sqrt(p.shape[0]))
    return model


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
def _edges(batch):
    edges = batch["edges"].to(torch.int64)
    return edges[:, 0], edges[:, 1]


def _fwd_gatedgcn(cfg: GNNConfig, p, batch):
    n = batch["feat"].shape[0]
    src, dst = _edges(batch)
    emask = batch["edge_mask"][:, None].to(cfg.dtype)
    p = cast_params(cfg, p)
    h = constrain(_apply(p.embed, batch["feat"].to(cfg.dtype)), "nodes", None)
    e = constrain(p.edge_embed.expand(src.shape[0], cfg.d_hidden), "edges", None)

    def layer(lp, h, e):
        dh = constrain(_at(_apply(lp.D, h), src), "edges", None)
        eh = constrain(_at(_apply(lp.E, h), dst), "edges", None)
        e_new = constrain(e + F.relu(_ln(_apply(lp.C, e) + dh + eh)), "edges", None)
        eta = constrain(torch.sigmoid(e_new) * emask, "edges", None)
        denom = constrain(seg_sum(eta, dst, n) + 1e-6, "nodes", None)
        bh = constrain(_at(_apply(lp.B, h), src), "edges", None)
        msg = constrain(seg_sum(eta * bh, dst, n), "nodes", None) / denom
        h = constrain(h + F.relu(_ln(_apply(lp.A, h) + msg)), "nodes", None)
        return h, e_new

    step = _layer(cfg, layer)
    for lp in p.layers:
        h, e = step(lp, h, e)
    return _readout(cfg, p, h, batch)


def _fwd_gat(cfg: GNNConfig, p, batch):
    n = batch["feat"].shape[0]
    src, dst = _edges(batch)
    emask = batch["edge_mask"].to(cfg.dtype)
    h = constrain(batch["feat"].to(cfg.dtype), "nodes", None)

    def layer(lp, h, last):
        if _sharded(h):  # one node-sharded [N, f] x [f, H*D] product
            x, w = _promoted(h, lp.W)
            hw = constrain(x @ w.reshape(w.shape[0], -1), "nodes", None).reshape(
                n, *w.shape[1:])
        else:
            hw = _einsum("nf,fhd->nhd", h, lp.W)  # [N, H, D]
        al = _einsum("nhd,hd->nh", hw, lp.a_src)
        ar = _einsum("nhd,hd->nh", hw, lp.a_dst)
        logits = F.leaky_relu(
            constrain(_at(al, src), "edges", None) + constrain(_at(ar, dst), "edges", None), 0.2
        )  # [E, H]
        logits = constrain(
            torch.where(emask[:, None] > 0, logits,
                        torch.full((), -1e30, dtype=logits.dtype, device=h.device)),
            "edges", None)
        alpha = constrain(seg_softmax(logits, dst, n) * emask[:, None], "edges", None)
        if _sharded(alpha, hw):  # the plain formula, edge-sharded
            alpha, hw = _promoted(alpha, hw)
            hws = constrain(_at(hw, src), "edges", None, None)
            out = seg_sum(alpha[:, :, None] * hws, dst, n)
        else:
            out = _WeightedGatherScatter.apply(*_promoted(alpha, hw), src, dst, n)
        out = constrain(out, "nodes", None, None)  # [N, H, D]
        if last:
            return constrain(torch.mean(out, dim=1), "nodes", None)
        return constrain(F.elu(out).reshape(n, -1), "nodes", None)

    for i, lp in enumerate(p.layers):
        last = i == len(p.layers) - 1
        h = _layer(cfg, functools.partial(layer, last=last))(lp, h)
    return _readout(cfg, p, h, batch, head=False)


def _fwd_pna(cfg: GNNConfig, p, batch, delta: float = 2.5):
    n = batch["feat"].shape[0]
    src, dst = _edges(batch)
    emask = batch["edge_mask"][:, None].to(cfg.dtype)
    h = constrain(_apply(p.embed, batch["feat"].to(cfg.dtype)), "nodes", None)
    deg = seg_sum(emask, dst, n)  # [N, 1]
    logd = torch.log(deg + 1.0)

    def layer(lp, h):
        hs = constrain(_at(h, src), "edges", None)
        hd = constrain(_at(h, dst), "edges", None)
        msg = constrain(F.relu(_apply(lp.pre, torch.cat([hs, hd], dim=-1))) * emask,
                        "edges", None)  # [E, d]
        mean = constrain(seg_mean(msg, dst, n, deg), "nodes", None)
        mx = constrain(seg_max(msg, dst, n), "nodes", None)
        mn = constrain(seg_min(msg, dst, n), "nodes", None)
        var = constrain(seg_mean(msg * msg, dst, n, deg), "nodes", None) - mean * mean
        std = torch.sqrt(torch.clamp(var, min=1e-6))
        aggs = torch.cat([mean, mx, mn, std], dim=-1)  # [N, 4d]
        amp = logd / delta
        att = delta / torch.clamp(logd, min=1e-2)
        scaled = constrain(torch.cat([aggs, aggs * amp, aggs * att, h], dim=-1),
                           "nodes", None)
        return constrain(h + F.relu(_apply(lp.post, scaled)), "nodes", None)

    step = _layer(cfg, layer)
    for lp in p.layers:
        h = step(lp, h)
    return _readout(cfg, p, h, batch)


def _ssp(x):  # shifted softplus
    return F.softplus(x) - math.log(2.0)


def _fwd_schnet(cfg: GNNConfig, p, batch):
    n = batch["feat"].shape[0]
    src, dst = _edges(batch)
    emask = batch["edge_mask"][:, None].to(cfg.dtype)
    z = batch["feat"]
    if z.dim() == 2:  # dense features -> project to type logits
        z = (torch.argmax(z[:, :100], dim=-1) if z.shape[1] >= 2
             else z[:, 0].to(torch.int32))
    h = p.embed[torch.clamp(z, 0, 99).to(torch.int64)]  # [N, d]
    pos = batch["positions"].to(cfg.dtype)
    dist = torch.sqrt(
        torch.sum((_at(pos, src) - _at(pos, dst)) ** 2, dim=-1, keepdim=True) + 1e-12
    )  # [E, 1]
    centers = _linspace(cfg.cutoff, cfg.n_rbf, cfg.dtype, dist.device)
    gamma = 10.0
    rbf = constrain(torch.exp(-gamma * (dist - centers[None, :]) ** 2),
                    "edges", None)  # [E, n_rbf]
    cos_cut = 0.5 * (torch.cos(math.pi * torch.clamp(dist, max=cfg.cutoff) / cfg.cutoff)
                     + 1.0)

    def layer(lp, h):
        w = constrain(_ssp(_apply(lp.filt2, _ssp(_apply(lp.filt1, rbf)))) * cos_cut,
                      "edges", None)
        hs = constrain(_at(_apply(lp.lin1, h), src), "edges", None)
        msg = constrain(hs * w * emask, "edges", None)
        agg = constrain(seg_sum(msg, dst, n), "nodes", None)
        return constrain(h + _apply(lp.lin2, _ssp(agg)), "nodes", None)

    step = _layer(cfg, layer)
    for lp in p.layers:
        h = step(lp, h)
    h = _apply(p.out1, h)
    h = _apply(p.out2, _ssp(h))  # [N, n_out]
    if cfg.task == "graph_reg":
        return seg_sum(h, batch["node_graph"].to(torch.int64), batch["n_graphs"])
    return h


# --------------------------------------------------------------------- #
# shared readout / dispatch
# --------------------------------------------------------------------- #
def _readout(cfg: GNNConfig, p, h, batch, head: bool = True):
    if head:
        h = _apply(p.head, h)
    if cfg.task == "graph_reg":
        g = batch["node_graph"].to(torch.int64)
        ng = batch["n_graphs"]
        cnt = seg_sum(torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device), g, ng)
        return seg_sum(h, g, ng) / torch.clamp(cnt, min=1.0)
    return h


_FWD = {
    "gatedgcn": _fwd_gatedgcn,
    "gat": _fwd_gat,
    "pna": _fwd_pna,
    "schnet": _fwd_schnet,
}


def forward(cfg: GNNConfig, params, batch: dict) -> torch.Tensor:
    return _FWD[cfg.arch](cfg, params, batch)


def loss_fn(cfg: GNNConfig, params, batch: dict) -> torch.Tensor:
    out = forward(cfg, params, batch)
    if cfg.task == "graph_reg":
        tgt = batch["labels"].to(torch.float32)
        return torch.mean((out[..., 0].to(torch.float32) - tgt) ** 2)
    labels = batch["labels"].to(torch.int64)
    mask = (labels >= 0).to(torch.float32)
    lp = torch.log_softmax(out.to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, torch.clamp(labels, min=0)[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
