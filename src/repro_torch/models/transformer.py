"""Decoder-only LM family: dense GQA transformers and MoE variants.

Covers the LM architectures of the JAX package (internlm2-1.8b, qwen3-8b,
yi-6b, olmoe-1b-7b, mixtral-8x7b): grouped-query attention, RoPE, optional
QK-norm (qwen3), optional sliding-window attention (mixtral), SwiGLU FFN,
and top-k token-choice MoE with group-local sort-based dispatch
(:func:`moe_block`).

Parameters live in an :class:`LM` module (a ``ModuleList`` of layers, f32
masters); the functions below read them by attribute, so they take either
the module or :func:`cast_params`' copy of it in the activation dtype.
Attention and the loss are plain torch products, in the JAX package's
formulation: f32 logits from the activations, a -1e30 mask with a -1e9
floor on the running max, the probabilities cast back to the activation
dtype before the PV product.  The MoE block is plain torch too, as the
JAX package's is plain ``jnp``: a stable sort, ``index_put`` and batched
expert products.

The reference's ``constrain`` sites annotate activations with logical
axes; outside a rule context they do nothing.  Under one, on DTensors
(the dry-run), four pieces run shard-local through ``local_map``, where
DTensor's own rules would gather or fail: attention over batch and head
shards (:func:`_attend`), decode attention and the cache's roll over a
KV cache whose sequence is split (:func:`_attend_split`,
:func:`_roll_split`), the MoE block over the experts' split
(:func:`_moe_sharded`), and the cross entropy's target logit, a one-hot
contraction over the vocab-sharded logits.  The serving steps keep the
cache in ``shard.lm_cache_spec``'s placement: prefill returns it so, and
decode attends over it and rolls it without gathering it.
"""
from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import ctx
from repro_torch.distributed import shard as sh
from repro_torch.distributed.ctx import constrain, group_count, lookup

MASK_VALUE = -1e30  # additive bias of a masked (query, key) pair
MAX_FLOOR = -1e9  # floor of the running max: a fully masked row gets p = 0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    sliding_window: int | None = None
    moe: MoEConfig | None = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def full_attention(self) -> bool:
        return self.sliding_window is None

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        d, h, kv, hd, f, v = (
            self.d_model,
            self.n_heads,
            self.n_kv_heads,
            self.head_dim,
            self.d_ff,
            self.vocab,
        )
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts top_k experts only."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            self.moe.n_experts * 3 * d * self.moe.d_expert
        )
        return dense + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def _empty(shape, cfg: LMConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


def _ones(n: int, cfg: LMConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=cfg.param_dtype, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = _empty((d, h * hd), cfg, device)
        self.wk = _empty((d, kv * hd), cfg, device)
        self.wv = _empty((d, kv * hd), cfg, device)
        self.wo = _empty((h * hd, d), cfg, device)
        if cfg.qk_norm:
            self.q_norm = _ones(hd, cfg, device)
            self.k_norm = _ones(hd, cfg, device)


class MLP(nn.Module):
    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _empty((d, f), cfg, device)
        self.w_up = _empty((d, f), cfg, device)
        self.w_down = _empty((f, d), cfg, device)


class MoE(nn.Module):
    """The router ``[d, E]`` and the experts' SwiGLU weights, stacked on a
    leading expert axis: gate and up ``[E, d, fe]``, down ``[E, fe, d]``."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        d, e, fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
        self.router = _empty((d, e), cfg, device)
        self.w_gate = _empty((e, d, fe), cfg, device)
        self.w_up = _empty((e, d, fe), cfg, device)
        self.w_down = _empty((e, fe, d), cfg, device)


class Layer(nn.Module):
    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.attn = Attention(cfg, device)
        self.ln1 = _ones(cfg.d_model, cfg, device)
        self.ln2 = _ones(cfg.d_model, cfg, device)
        if cfg.moe is not None:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)


class LM(nn.Module):
    """The parameters of an LM, uninitialised (``init_params`` draws
    them; ``convert.lm_params_from_numpy`` copies the JAX package's)."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.embed = _empty((cfg.vocab, cfg.d_model), cfg, device)
        self.unembed = _empty((cfg.d_model, cfg.vocab), cfg, device)
        self.ln_f = _ones(cfg.d_model, cfg, device)
        self.layers = nn.ModuleList(Layer(cfg, device) for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: LMConfig, seed: int = 0, *, device=DEFAULT_DEVICE) -> LM:
    """A random LM: every matrix ``normal / sqrt(fan_in)`` from a
    ``torch.Generator`` on ``device`` seeded with ``seed``, norms at one.
    A matrix is ``[fan_in, fan_out]``, an expert stack ``[E, fan_in,
    fan_out]`` (``d`` for gate and up, ``d_expert`` for down), and the
    embedding ``[vocab, d]`` has fan-in ``d``."""
    device = resolve_device(device)
    model = LM(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            fan_in = cfg.d_model if name == "embed" else p.shape[-2]
            p.normal_(generator=gen).div_(math.sqrt(fan_in))
    return model


def cast_params(cfg: LMConfig, params: LM) -> types.SimpleNamespace:
    """The module's parameter tree with every f32 tensor cast to the activation
    dtype, made once per step; gradients flow back through the cast into
    the f32 masters.  No-op casts for bf16 params."""

    def tree(mod: nn.Module):
        if isinstance(mod, nn.ModuleList):
            return [tree(m) for m in mod]
        out = types.SimpleNamespace()
        for name, t in mod.named_parameters(recurse=False):
            setattr(out, name, t.to(cfg.dtype) if t.dtype == torch.float32 else t)
        for name, child in mod.named_children():
            setattr(out, name, tree(child))
        return out

    return tree(params)


# --------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S].  Frequencies and angles in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mask_bias(
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None
) -> torch.Tensor:
    """[B, 1, 1, Sq, Sk] additive f32 mask: causal (+ sliding window)."""
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= k_pos[:, None, :] > q_pos[:, :, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok[:, None, None], zero, MASK_VALUE)


def _logits(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor, scale: float):
    """f32 logits [B, KV, G, cq, ck] of q [B, KV, G, cq, hd] against
    k [B, KV, ck, hd] (exact for bf16 inputs), scaled, plus the mask."""
    b, kvh, g, cq, hd = q.shape
    qf = q.to(torch.float32).reshape(b, kvh, g * cq, hd)
    logits = (qf @ k.to(torch.float32).transpose(-1, -2)).reshape(b, kvh, g, cq, -1)
    return logits * scale + bias


def _pv(p: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """p [B, KV, G, cq, ck] cast to the activation dtype, times
    v [B, KV, ck, hd] -> [B, KV, G, cq, hd]."""
    b, kvh, g, cq, ck = p.shape
    o = p.to(dtype).reshape(b, kvh, g * cq, ck) @ v
    return o.reshape(b, kvh, g, cq, -1)


def _sdpa_block(q, k, v, bias, scale):
    """GQA block attention.  q: [B, KV, G, cq, hd]; k/v: [B, KV, ck, hd];
    bias: [B, 1, 1, cq, ck].  Returns (o [B,KV,G,cq,hd], m, l)."""
    logits = _logits(q, k, bias, scale)
    # clamp the running max above the mask value so fully-masked rows get
    # p = exp(-1e30 + 1e9) = 0 instead of exp(0) = 1.
    m = torch.clamp(torch.amax(logits, dim=-1), min=MAX_FLOOR)
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, dim=-1)
    return _pv(p, v, q.dtype), m, l


def gqa_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KV, hd]
    v: torch.Tensor,  # [B, Sk, KV, hd]
    q_pos: torch.Tensor,  # [B, Sq]
    k_pos: torch.Tensor,  # [B, Sk]
    *,
    window: int | None,
    chunk_q: int = 1024,
    chunk_k: int = 2048,
) -> torch.Tensor:
    """Flash-style chunked GQA attention (online softmax, O(S) memory).

    Falls back to a single unchunked block for short sequences.  Never
    materializes the repeated-KV tensor nor the full S x S logits.
    """
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4)  # [B, KV, G, Sq, hd]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # [B, KV, Sk, hd]

    if sq * sk <= chunk_q * chunk_k * 4:  # small: one block
        bias = _mask_bias(q_pos, k_pos, window)
        o, m, l = _sdpa_block(qg, kt, vt, bias, scale)
        o = o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype)
        return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)

    nq = -(-sq // chunk_q)
    nk = -(-sk // chunk_k)
    sq_p, sk_p = nq * chunk_q, nk * chunk_k
    qg = F.pad(qg, (0, 0, 0, sq_p - sq))
    kt = F.pad(kt, (0, 0, 0, sk_p - sk))
    vt = F.pad(vt, (0, 0, 0, sk_p - sk))
    # padded k positions must never be attended: put them far in the future
    kpos_p = F.pad(k_pos, (0, sk_p - sk), value=2**30)
    qpos_p = F.pad(q_pos, (0, sq_p - sq), value=0)

    outs = []
    for i in range(nq):
        qs = slice(i * chunk_q, (i + 1) * chunk_q)
        qc, qpc = qg[:, :, :, qs], qpos_p[:, qs]
        m = torch.full((b, kvh, g, chunk_q), MAX_FLOOR, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, chunk_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, chunk_q, hd), dtype=q.dtype, device=q.device)
        for j in range(nk):
            ks = slice(j * chunk_k, (j + 1) * chunk_k)
            logits = _logits(qc, kt[:, :, ks], _mask_bias(qpc, kpos_p[:, ks], window),
                             scale)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None].to(acc.dtype) + _pv(p, vt[:, :, ks], qc.dtype)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(o.permute(0, 3, 1, 2, 4))  # [B, cq, KV, G, hd]
    o = torch.cat(outs, dim=1).reshape(b, sq_p, h, hd)
    return o[:, :sq]


def _attend(q, k, v, q_pos, k_pos, window):
    """:func:`gqa_attention`; on DTensors, shard-local: the batch over the
    ``batch`` rule's axes and the query heads over the ``heads`` rule's,
    each shard attending with the key/value heads its query heads read
    (kept sharded with them where a shard's query heads cover whole groups,
    else replicated and sliced), through ``local_map``."""
    if not isinstance(q, DTensor):
        return gqa_attention(q, k, v, q_pos, k_pos, window=window)
    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    bat, _, heads, _ = (ctx.logical_spec(tuple(q.shape), "batch", None, "heads", None)
                        or (None,) * 4)
    hl = h // sh.axis_size(mesh, heads)  # query heads a shard holds
    if hl % g and g % hl:  # a shard's heads straddle two kv groups: batch only
        heads, hl = None, h
    kv_sharded = heads is not None and hl % g == 0
    qpl = sh.to_placements(sh.P(bat, None, heads, None), mesh)
    kpl = sh.to_placements(sh.P(bat, None, heads if kv_sharded else None, None), mesh)
    ppl = sh.to_placements(sh.P(bat, None), mesh)

    def local(ql, kl, vl, qp, kp):
        if heads is not None and not kv_sharded:  # this shard's heads share a kv head
            j = ctx.shard_index(mesh, heads)[0] * hl // g
            kl, vl = kl[:, :, j:j + 1], vl[:, :, j:j + 1]
        return gqa_attention(ql, kl, vl, qp, kp, window=window)

    q_pos, k_pos = ctx.as_dtensor(q_pos, mesh), ctx.as_dtensor(k_pos, mesh)
    # replicated key/value heads, sliced a shard: their gradient is a
    # partial sum over the heads' dims
    sliced = ({k for k, pl in enumerate(sh.to_placements(sh.P(heads), mesh))
               if pl != Replicate()} if heads is not None and not kv_sharded else set())
    kgrad = ctx.partial_where(kpl, sliced)
    return ctx.local_map(local, list(qpl), (qpl, kpl, kpl, ppl, ppl), mesh,
                         (None, kgrad, kgrad, None, None))(q, k, v, q_pos, k_pos)


def _split_dims(t: torch.Tensor, dim: int) -> tuple[int, ...]:
    """The mesh dims that split tensor dim ``dim`` of a DTensor, major to
    minor (none for a plain tensor)."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(k for k, p in enumerate(t.placements) if p == Shard(dim))


def _attend_split(q, k, v, k_cache, v_cache, q_pos, k_pos, window):
    """One token's attention over a KV cache ``[B, S, kv, hd]`` whose
    sequence is split across the mesh (``shard.lm_cache_spec``), as flash
    decoding splits it, through ``local_map``: each shard takes its batch
    rows of ``q [B, 1, h, hd]`` with every query head, its slice of the
    cache and of ``k_pos``, and computes the softmax's unnormalised partial
    ``(m, l, acc)`` in f32 over its keys, as :func:`_sdpa_block` does.  The
    new token's key and value (``k``, ``v [B, 1, kv, hd]``) join the last
    shard's partial, the shard that holds them after the roll.  The
    partials merge over the sequence's mesh dims (an all-reduce max of
    ``m``, then one all-reduce sum of ``l`` and ``acc``); a shard whose
    keys are all masked adds 0 (its ``m`` sits at the floor).  The output
    keeps the query heads split as :func:`_attend`'s does."""
    from torch.distributed import _functional_collectives as funcol

    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    cpl = tuple(k_cache.placements)  # the cache's, and k_pos's [B, S]
    seq = _split_dims(k_cache, 1)
    bpl = tuple(p if p == Shard(0) else Replicate() for p in cpl)  # the batch rows
    b, _, h, hd = q.shape
    heads = (ctx.logical_spec(tuple(q.shape), "batch", None, "heads", None) or (None,) * 4)[2]
    hdims = [names.index(a) for a in ((heads,) if isinstance(heads, str) else heads or ())]
    if any(bpl[k] != Replicate() for k in hdims):
        heads, hdims = None, []
    opl = [Shard(2) if k in hdims else p for k, p in enumerate(bpl)]
    hl = h // sh.axis_size(mesh, heads)
    idx, n = ctx.shard_index(mesh, tuple(names[k] for k in seq))
    scale = 1.0 / math.sqrt(hd)

    def local(ql, kc, vc, kn, vn, qp, kp):
        bl, kvh = ql.shape[0], kc.shape[2]
        qg = ql.reshape(bl, 1, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4)  # [B, KV, G, 1, hd]
        logits = _logits(qg, kc.transpose(1, 2), _mask_bias(qp, kp, window), scale)
        if idx == n - 1:
            new = _logits(qg, kn.transpose(1, 2), _mask_bias(qp, qp, window), scale)
            logits = torch.cat([logits, new], dim=-1)
        m = torch.clamp(torch.amax(logits, dim=-1), min=MAX_FLOOR)
        p = torch.exp(logits - m[..., None])
        # the PV product of p cast to the activation dtype, as _pv's, summed
        # in f32 over the cache and the new token and rounded once below
        s_l = kc.shape[1]
        pc = p.to(ql.dtype).to(torch.float32)
        acc = _pv(pc[..., :s_l], vc.to(torch.float32).transpose(1, 2), torch.float32)
        if p.shape[-1] > s_l:
            acc = acc + _pv(pc[..., s_l:], vn.to(torch.float32).transpose(1, 2), torch.float32)
        m_all = m
        for d in seq:
            m_all = funcol.all_reduce(m_all, "max", (mesh, d))
        corr = torch.exp(m - m_all)
        la = torch.cat([acc * corr[..., None], (torch.sum(p, dim=-1) * corr)[..., None]], -1)
        for d in seq:
            la = funcol.all_reduce(la, "sum", (mesh, d))
        # normalised in the activation dtype, as gqa_attention's one block is
        o = la[..., :hd].to(ql.dtype) / torch.clamp(la[..., hd:], min=1e-30).to(ql.dtype)
        o = o.permute(0, 3, 1, 2, 4).reshape(bl, 1, h, hd)
        j = ctx.shard_index(mesh, heads)[0] * hl
        return o[:, :, j:j + hl]

    q_pos, k_pos = ctx.as_dtensor(q_pos, mesh), ctx.as_dtensor(k_pos, mesh)
    return ctx.local_map(local, opl, (bpl, cpl, cpl, bpl, bpl, bpl, cpl), mesh)(
        q, k_cache, v_cache, k, v, q_pos, k_pos)


def _from_next(x: torch.Tensor, mesh, dims: tuple[int, ...]) -> torch.Tensor:
    """Inside ``local_map``: on each shard of the split of mesh dims
    ``dims`` (major to minor), the ``x`` of the next shard along that split,
    cyclically.  One collective permute a dim that splits, minor first; a
    more major dim's permute passes on what the minor ones brought, taken
    where every more minor index is at its end."""
    from torch.distributed import _functional_collectives as funcol

    out, done = x.reshape(-1), []
    for d in reversed(dims):
        n = mesh.size(d)
        if n > 1:
            moved = funcol.wait_tensor(
                funcol.permute_tensor(out, [(r - 1) % n for r in range(n)], (mesh, d)))
            if all(mesh.get_local_rank(e) == mesh.size(e) - 1 for e in done):
                out = moved
        done.append(d)
    return out.reshape(x.shape)


def _roll_split(k_cache, v_cache, k_new, v_new):
    """The decode roll, ``cat([cache, new], 2)[:, :, 1:]`` of a cache ``[L,
    B, S, kv, hd]`` and the new tokens' ``[L, B, 1, kv, hd]``, on a cache
    whose sequence is split across the mesh, without gathering it: each
    shard drops its first position and appends the next shard's first (one
    collective permute of ``[2, L, B_l, 1, kv, hd]`` a splitting mesh dim,
    along the split's order), the last shard the new tokens'.  The cache
    keeps its placements."""
    mesh = k_cache.device_mesh
    cpl = tuple(k_cache.placements)
    seq = _split_dims(k_cache, 2)
    npl = tuple(p if p == Shard(1) else Replicate() for p in cpl)
    idx, n = ctx.shard_index(mesh, tuple(mesh.mesh_dim_names[d] for d in seq))

    def local(kc, vc, kn, vn):
        nxt = _from_next(torch.stack([kc[:, :, :1], vc[:, :, :1]]), mesh, seq)
        if idx == n - 1:
            nxt = torch.stack([kn, vn]).to(kc.dtype)
        return torch.cat([kc[:, :, 1:], nxt[0]], 2), torch.cat([vc[:, :, 1:], nxt[1]], 2)

    return ctx.local_map(local, (list(cpl), list(cpl)), (cpl, cpl, npl, npl), mesh)(
        k_cache, v_cache, k_new, v_new)


def attention(
    cfg: LMConfig,
    p,
    x: torch.Tensor,  # [B, Sq, d]
    positions: torch.Tensor,  # [B, Sq]
    k_cache: torch.Tensor | None = None,  # [B, Sk, kv, hd]
    v_cache: torch.Tensor | None = None,
    k_pos: torch.Tensor | None = None,  # [B, Sk]
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    b, sq, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the flat projections take their heads' layout before the reshape
    # splits their last dim into heads (a split a shard boundary cannot cut)
    head_axis = "heads" if group_count("heads", h) > 1 else None
    q = constrain(x @ p.wq.to(cfg.dtype), "batch", None, head_axis).reshape(b, sq, h, hd)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(x @ p.wk.to(cfg.dtype), "batch", None, None).reshape(b, sq, kv, hd)
    v = constrain(x @ p.wv.to(cfg.dtype), "batch", None, None).reshape(b, sq, kv, hd)
    k = constrain(k, "batch", None, None, None)
    v = constrain(v, "batch", None, None, None)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if k_cache is not None and _split_dims(k_cache, 1):
        # a sequence-split cache is not extended here: the new (k, v) are
        # returned alone, and decode_step rolls them in (_roll_split)
        o = _attend_split(q, k, v, k_cache, v_cache, positions, k_pos, cfg.sliding_window)
        return o.reshape(b, sq, h * hd) @ p.wo.to(cfg.dtype), (k, v)
    if k_cache is not None:
        k_full = torch.cat([k_cache.to(k.dtype), k], dim=1)
        v_full = torch.cat([v_cache.to(v.dtype), v], dim=1)
        kp = torch.cat([k_pos, positions], dim=1)
    else:
        k_full, v_full, kp = k, v, positions

    o = _attend(q, k_full, v_full, positions, kp, cfg.sliding_window).reshape(b, sq, h * hd)
    return o @ p.wo.to(cfg.dtype), (k_full, v_full)


def swiglu(p, x: torch.Tensor, dtype) -> torch.Tensor:
    g = F.silu(x @ p.w_gate.to(dtype))
    u = x @ p.w_up.to(dtype)
    return constrain(g * u, "batch", None, "ff") @ p.w_down.to(dtype)


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """Where :func:`moe_block` sends each ``(token, k)`` slot of a group,
    the slots sorted by expert (stably, so by token within an expert):
    all ``[G, tl*k]`` but ``counts [G, E]``."""

    expert: torch.Tensor  # int64 expert id of each sorted slot
    token: torch.Tensor  # int64 token (within its group) of each sorted slot
    weight: torch.Tensor  # renormalised router weight, activation dtype
    pos: torch.Tensor  # int64 slot within (group, expert); >= cap is dropped
    counts: torch.Tensor  # int64 slots routed to each expert
    cap: int  # expert capacity per group

    @property
    def kept(self) -> torch.Tensor:
        """bool ``[G, tl*k]``: the slots inside their expert's capacity."""
        return self.pos < self.cap


def route(cfg: LMConfig, router: torch.Tensor, xg: torch.Tensor):
    """The router of :func:`moe_block` over ``xg [G, tl, d]``: (its
    softmax ``probs [G, tl, E]`` in f32, the :class:`Dispatch`).  Profiler
    ranges ``moe_router`` and ``moe_sort`` mark its two halves."""
    m = cfg.moe
    g_, tl, _ = xg.shape
    k, e = m.top_k, m.n_experts
    tkl = tl * k
    with record_function("moe_router"):
        gate_logits = xg.to(torch.float32) @ router.to(torch.float32)
        probs = torch.softmax(gate_logits, dim=-1)  # [G, tl, E]
        topw, topi = torch.topk(probs, k, dim=-1)  # [G, tl, K]
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    with record_function("moe_sort"):
        e_flat = topi.reshape(g_, tkl)
        w_flat = topw.reshape(g_, tkl).to(cfg.dtype)
        order = torch.sort(e_flat, dim=-1, stable=True).indices
        e_s = torch.gather(e_flat, -1, order)  # [G, TKl]
        tok_s = order // k  # slot i*k + j belongs to token i
        w_s = torch.gather(w_flat, -1, order)

        counts = torch.zeros((g_, e), dtype=torch.int64, device=xg.device)
        counts.scatter_add_(1, e_s, torch.ones_like(e_s))
        starts = torch.cumsum(counts, dim=-1) - counts
        pos = torch.arange(tkl, device=xg.device)[None] - torch.gather(starts, -1, e_s)
    return probs, Dispatch(e_s, tok_s, w_s, pos, counts, capacity(m, tl))


def capacity(m: MoEConfig, tl: int) -> int:
    """Expert capacity per group of ``tl`` tokens."""
    return max(int(math.ceil(tl * m.top_k / m.n_experts * m.capacity_factor)), m.top_k)


def moe_block(cfg: LMConfig, p, x: torch.Tensor, groups: int | None = None):
    """Token-choice top-k MoE with *group-local* sort-based dispatch.

    The token stream is blocked into ``G`` shard-local groups (G = the batch
    sharding degree from the logical-axis context; 1 in the port, which has
    none yet).  Within each group: sort the (token, k) slots by expert,
    derive each slot's position in its expert from the sorted prefix,
    scatter into a ``[E, C_local, d]`` buffer (out-of-capacity slots
    dropped: only the kept slots are written), run the expert SwiGLUs
    batched over ``[G, E]``, gather back (a dropped slot reads as 0) and
    weight-combine.  Returns (output, Switch load-balance aux loss).
    Profiler ranges ``moe_dispatch``, ``moe_experts`` and ``moe_combine``
    mark its stages after :func:`route`'s.
    """
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_experts
    g_ = groups if groups is not None else group_count("batch", t)
    tl = t // g_  # tokens per group
    xg = constrain(x.reshape(g_, tl, d), "batch", None, None)
    if isinstance(xg, DTensor):
        return _moe_sharded(cfg, p, xg, (b, s, d))
    probs, disp = route(cfg, p.router, xg)

    with record_function("moe_dispatch"):
        keep = disp.kept
        gi = torch.arange(g_, device=x.device)[:, None].expand_as(disp.expert)[keep]
        ek, pk, tk = disp.expert[keep], disp.pos[keep], disp.token[keep]
        buf = torch.zeros((g_, e, disp.cap, d), dtype=cfg.dtype, device=x.device)
        buf = buf.index_put((gi, ek, pk), xg[gi, tk].to(cfg.dtype), accumulate=True)
        buf = constrain(buf, "batch", "expert", None, None)  # [G, E, C, d]

    with record_function("moe_experts"):
        gact = F.silu(torch.einsum("gecd,edf->gecf", buf, p.w_gate.to(cfg.dtype)))
        u = torch.einsum("gecd,edf->gecf", buf, p.w_up.to(cfg.dtype))
        ye = constrain(torch.einsum("gecf,efd->gecd", gact * u, p.w_down.to(cfg.dtype)),
                       "batch", "expert", None, None)

    with record_function("moe_combine"):
        vals = ye[gi, ek, pk] * disp.weight[keep][:, None]  # dropped slots add 0
        yt = ye.new_zeros((g_, tl, d)).index_put((gi, tk), vals, accumulate=True)
        yt = constrain(yt, "batch", None, None)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    frac = torch.sum(disp.counts, dim=0).to(torch.float32) / (g_ * tl * m.top_k)
    pmean = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac * pmean)
    return yt.reshape(b, s, d), aux


def _moe_sharded(cfg: LMConfig, p, xg: DTensor, shape: tuple[int, int, int]):
    """:func:`moe_block` on a DTensor ``xg [G, tl, d]``, its groups over the
    ``batch`` rule's axes, through ``local_map``.  The experts are split
    over the ``expert`` rule's axes where they divide the expert count
    (expert parallelism), else each expert's ``d_expert`` over the ``ff``
    rule's (tensor parallelism); the router and the weights' ``d_model``
    are gathered.  Every shard routes its groups' tokens (replicated across
    the split), dispatches the slots of its own experts into a
    fixed-shape buffer (a dropped slot lands in one spare row that is cut
    off), and combines its experts' share of each token: the output is a
    partial sum across the split, and the aux loss's routed fractions and
    mean probabilities are averages across the groups' shards.  Every
    replicated argument's gradient is a partial sum across the shards that
    use it differently.

    Without gradients, where the tokens are replicated over the mesh dims
    that split the weights' ``d_model`` (FSDP's; a batch-1 decode) and
    their dispatched slots are fewer elements than the weights a shard
    would gather, the weights stay where they lie: each shard contracts
    its slice of ``d_model``, the gate and up products are all-reduced
    over those dims, and the output comes back split over them."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial

    m = cfg.moe
    e, fe = m.n_experts, m.d_expert
    g_, tl, d = xg.shape
    mesh = xg.device_mesh
    bat = (ctx.logical_spec((g_,), "batch") or sh.P(None))[0]
    ep = (ctx.logical_spec((e,), "expert") or sh.P(None))[0]
    split = ep if ep is not None else (ctx.logical_spec((fe,), "ff") or sh.P(None))[0]
    e_l = e // sh.axis_size(mesh, ep)
    if ep is not None:
        wg_pl = wd_pl = sh.to_placements(sh.P(ep, None, None), mesh)
    else:
        wg_pl = sh.to_placements(sh.P(None, None, split), mesh)
        wd_pl = sh.to_placements(sh.P(None, split, None), mesh)
    xpl = sh.to_placements(sh.P(bat, None, None), mesh)
    rpl = sh.to_placements(sh.P(), mesh)
    split_dims = {i for i, pl in enumerate(sh.to_placements(sh.P(split), mesh))
                  if pl != Replicate()}
    batch_dims = {k for k, pl in enumerate(xpl) if pl != Replicate()}
    fsdp = _split_dims(p.w_gate, 1)
    n_fsdp = math.prod(mesh.size(k) for k in fsdp)
    fsdp_names = tuple(mesh.mesh_dim_names[k] for k in fsdp)
    # the weights stay where the gate and up partials a shard all-reduces,
    # 2 x [G_l, E_l, C, fe_l], are fewer than the 3 x [E_l, d (n-1)/n, fe_l]
    # it would gather
    stay = (bool(fsdp) and not torch.is_grad_enabled() and fsdp == _split_dims(p.w_down, 2)
            and not set(fsdp) & (batch_dims | split_dims)
            and 2 * (g_ // sh.axis_size(mesh, bat)) * capacity(m, tl) * n_fsdp
            < 3 * d * (n_fsdp - 1))
    if stay:
        wg_pl = tuple(Shard(1) if k in fsdp else pl for k, pl in enumerate(wg_pl))
        wd_pl = tuple(Shard(2) if k in fsdp else pl for k, pl in enumerate(wd_pl))
    ypl = [Partial() if k in split_dims else Shard(2) if stay and k in fsdp else pl
           for k, pl in enumerate(xpl)]
    # the aux loss's terms average over the groups' shards and over the
    # split (where every shard holds the same terms), each shard's share a
    # partial sum of the mean divided by their count (a ``Partial("avg")``
    # output's backward would hand every shard the whole gradient), so
    # that every replicated argument's gradient is a partial sum over the
    # dims where the shards differ: the tokens' over the split (each
    # shard's experts), the router's over the split and the groups, the
    # expert weights' over the groups
    avg_dims = batch_dims | split_dims
    n_avg = math.prod(mesh.size(k) for k in avg_dims)
    apl = [Partial() if k in avg_dims else Replicate() for k in range(mesh.ndim)]
    grads = (ctx.partial_where(xpl, split_dims), ctx.partial_where(rpl, batch_dims | split_dims),
             ctx.partial_where(wg_pl, batch_dims), ctx.partial_where(wg_pl, batch_dims),
             ctx.partial_where(wd_pl, batch_dims))

    def local(xl, router, wg, wu, wd):
        gl = xl.shape[0]
        probs, disp = route(cfg, router, xl)
        le = disp.expert - ctx.shard_index(mesh, ep)[0] * e_l
        keep = disp.kept & (le >= 0) & (le < e_l)
        gi = torch.arange(gl, device=xl.device)[:, None].expand_as(le)
        ek = torch.where(keep, le, torch.zeros_like(le))
        pk = torch.where(keep, disp.pos, torch.full_like(disp.pos, disp.cap))
        xd = xl
        if stay:  # this shard's slice of d_model
            lo = ctx.shard_index(mesh, fsdp_names)[0] * wg.shape[1]
            xd = xl[..., lo:lo + wg.shape[1]]
        vals = xd[gi, disp.token].to(cfg.dtype) * keep[..., None].to(cfg.dtype)
        buf = xl.new_zeros((gl, e_l, disp.cap + 1, xd.shape[-1]), dtype=cfg.dtype)
        buf = buf.index_put((gi, ek, pk), vals, accumulate=True)[:, :, :disp.cap]
        if stay:  # the gate and up products' partial sums over d_model
            gu = torch.stack([torch.einsum("gecd,edf->gecf", buf, wg.to(cfg.dtype)),
                              torch.einsum("gecd,edf->gecf", buf, wu.to(cfg.dtype))])
            for k in fsdp:
                gu = funcol.all_reduce(gu, "sum", (mesh, k))
            gact, u = F.silu(gu[0]), gu[1]
        else:
            gact = F.silu(torch.einsum("gecd,edf->gecf", buf, wg.to(cfg.dtype)))
            u = torch.einsum("gecd,edf->gecf", buf, wu.to(cfg.dtype))
        ye = F.pad(torch.einsum("gecf,efd->gecd", gact * u, wd.to(cfg.dtype)),
                   (0, 0, 0, 1))  # the spare row reads 0
        w = (disp.weight * keep.to(disp.weight.dtype))[..., None]
        yt = ye.new_zeros((gl, tl, ye.shape[-1])).index_put(
            (gi, disp.token), ye[gi, ek, pk] * w, accumulate=True)
        frac = torch.sum(disp.counts, dim=0).to(torch.float32) / (gl * tl * m.top_k)
        return yt, frac / n_avg, torch.mean(probs, dim=(0, 1)) / n_avg

    yt, frac, pmean = ctx.local_map(
        local, (ypl, apl, apl), (xpl, rpl, wg_pl, wg_pl, wd_pl), mesh, grads,
    )(xg, p.router, p.w_gate, p.w_up, p.w_down)
    yt = constrain(yt, "batch", None, None)
    return yt.reshape(shape), e * torch.sum(frac * pmean)


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
def _ffn(cfg: LMConfig, lp, hin) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer's feed-forward half: (output, aux loss; 0 for a dense FFN)."""
    if cfg.moe:
        return moe_block(cfg, lp.moe, hin)
    return swiglu(lp.mlp, hin, cfg.dtype), torch.zeros((), dtype=torch.float32,
                                                        device=hin.device)


def _layer_fwd(cfg: LMConfig, lp, x, positions):
    a, _ = attention(cfg, lp.attn, rmsnorm(x, lp.ln1, cfg.norm_eps), positions)
    x = constrain(x + a, "batch", None, None)
    y, aux = _ffn(cfg, lp, rmsnorm(x, lp.ln2, cfg.norm_eps))
    return constrain(x + y, "batch", None, None), aux


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def forward(cfg: LMConfig, params, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: tokens [B, S] -> (hidden [B, S, d], aux).

    The unembedding is applied separately (chunked, in the loss / serving
    head) so the full [B, S, V] logits tensor is never materialized.
    ``aux`` is the MoE load-balance loss averaged over the layers (0 for a
    dense model).
    """
    positions = _positions(tokens)
    x = constrain(lookup(params.embed.to(cfg.dtype), tokens), "batch", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        if cfg.remat:
            x, a = checkpoint(_layer_fwd, cfg, lp, x, positions, use_reentrant=False)
        else:
            x, a = _layer_fwd(cfg, lp, x, positions)
        aux = aux + a
    x = rmsnorm(x, params.ln_f, cfg.norm_eps)
    return x, aux / cfg.n_layers


def logits_of(cfg: LMConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ params.unembed.to(cfg.dtype)


def _onehot(idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """f32 ``[B, c, V]`` one-hot of ``idx [B, c, 1]``, vocab-sharded under
    the rules (the target-logit contraction of a vocab-sharded DTensor)."""
    hot = (torch.arange(vocab, device=idx.device) == idx).to(torch.float32)
    return constrain(hot, "batch", None, "vocab")


class _ChunkCE(torch.autograd.Function):
    """Summed masked cross entropy of one sequence chunk: ``sum((lse - tgt)
    * mask)`` with f32 logits ``hc @ w``.  One ``[B, c, V]`` f32 slab is
    live at a time, in the forward and in the backward, which recomputes
    the logits instead of saving them.  On DTensors, where the logits are
    vocab-sharded, the target logit is a one-hot contraction (a gather
    across the sharded vocab would need the whole row)."""

    @staticmethod
    def forward(ctx, hc, w, lc):
        logits = constrain((hc @ w).to(torch.float32), "batch", None, "vocab")  # [B, c, V]
        idx = torch.clamp(lc, min=0).to(torch.int64)[..., None]
        if isinstance(logits, DTensor):
            tgt = torch.sum(logits * _onehot(idx, logits.shape[-1]), dim=-1)
        else:
            tgt = torch.gather(logits, -1, idx)[..., 0]
        m = torch.amax(logits, dim=-1)
        lse = torch.log(torch.sum(logits.sub_(m[..., None]).exp_(), dim=-1)) + m
        mask = (lc >= 0).to(torch.float32)
        ctx.save_for_backward(hc, w, idx, lse, mask)
        return torch.sum((lse - tgt) * mask)

    @staticmethod
    def backward(ctx, grad):
        hc, w, idx, lse, mask = ctx.saved_tensors
        d = constrain((hc @ w).to(torch.float32), "batch", None, "vocab")
        d.sub_(lse[..., None]).exp_()  # softmax
        if isinstance(d, DTensor):
            d = d - _onehot(idx, d.shape[-1])
        else:
            d.scatter_add_(-1, idx, torch.full_like(idx, -1, dtype=d.dtype))
        d.mul_((grad * mask)[..., None])
        d = d.to(hc.dtype)
        grad_h = d @ w.transpose(0, 1) if ctx.needs_input_grad[0] else None
        grad_w = None
        if ctx.needs_input_grad[1]:
            grad_w = hc.reshape(-1, hc.shape[-1]).transpose(0, 1) @ d.reshape(-1, d.shape[-1])
        return grad_h, grad_w, None


def chunked_ce(
    cfg: LMConfig,
    params,
    hidden: torch.Tensor,  # [B, S, d]
    labels: torch.Tensor,  # [B, S] (-1 = masked)
    chunk: int = 1024,
) -> torch.Tensor:
    """Cross entropy without materializing [B, S, V]: per sequence chunk,
    the logits, their logsumexp and the target logit."""
    b, s, d = hidden.shape
    w = params.unembed.to(cfg.dtype)
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    h = F.pad(hidden, (0, 0, 0, pad)) if pad else hidden
    l = F.pad(labels, (0, pad), value=-1) if pad else labels
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        hc, lc = h[:, i * chunk:(i + 1) * chunk], l[:, i * chunk:(i + 1) * chunk]
        tot = tot + _ChunkCE.apply(hc, w, lc)
        cnt = cnt + torch.sum((lc >= 0).to(torch.float32))
    return tot / torch.clamp(cnt, min=1.0)


def _cache_placements(cfg: LMConfig, x: torch.Tensor, batch: int, seq: int) -> dict | None:
    """The placements ``shard.lm_cache_spec`` gives a cache of ``seq``
    positions over ``x``'s mesh: a layer's ``[B, S, kv, hd]`` (``"layer"``)
    and ``"pos"``; None for a plain ``x``."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    specs = sh.lm_cache_spec(mesh, cfg, batch, seq)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    kv = sh.named(mesh, shape, specs["k"]).placements
    return {"layer": tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in kv),
            "pos": sh.named(mesh, (batch,), specs["pos"]).placements}


@torch.no_grad()
def prefill_step(cfg: LMConfig, params, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Serving prefill: build the KV cache, return last-position logits.
    On DTensors the cache comes back in ``shard.lm_cache_spec``'s placement
    (the window's length where ``sliding_window`` trims it): each layer's
    keys and values, replicated where the cache splits its sequence, are
    cut to the shard's slice there, which moves nothing."""
    b, s = tokens.shape
    positions = _positions(tokens)
    x = lookup(params.embed.to(cfg.dtype), tokens)
    win = cfg.sliding_window
    place = _cache_placements(cfg, x, b, min(s, win) if win is not None else s)
    ks, vs = [], []
    for lp in params.layers:
        a, (k, v) = attention(
            cfg, lp.attn, rmsnorm(x, lp.ln1, cfg.norm_eps), positions
        )
        x = x + a
        x = x + _ffn(cfg, lp, rmsnorm(x, lp.ln2, cfg.norm_eps))[0]
        if win is not None:
            k, v = k[:, -win:], v[:, -win:]
        if place is not None:
            k = k.redistribute(k.device_mesh, place["layer"])
            v = v.redistribute(v.device_mesh, place["layer"])
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params.ln_f, cfg.norm_eps)
    last_logits = x[:, -1] @ params.unembed.to(cfg.dtype)
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    if place is not None:
        pos = ctx.as_dtensor(pos, x.device_mesh).redistribute(x.device_mesh, place["pos"])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pos}
    return last_logits, cache


def init_kv_cache(cfg: LMConfig, batch: int, seq: int, *, device=DEFAULT_DEVICE) -> dict:
    """Pre-filled KV cache stand-in for decode shapes.  For sliding-window
    attention the cache only ever holds the last ``window`` positions."""
    device = resolve_device(device)
    s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.full((batch,), s, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decode_step(
    cfg: LMConfig, params, cache: dict, tokens: torch.Tensor
) -> tuple[torch.Tensor, dict]:
    """One-token decode: tokens [B, 1]; rolling cache for SWA.  A cache
    whose sequence is split across the mesh (``shard.lm_cache_spec``) is
    attended over where it lies and rolled by :func:`_roll_split`; it keeps
    its placements, as ``pos`` does."""
    positions = cache["pos"][:, None]  # [B, 1]
    x = lookup(params.embed.to(cfg.dtype), tokens)
    s_cache = cache["k"].shape[2]
    k_pos = positions - s_cache + torch.arange(
        s_cache, dtype=torch.int32, device=tokens.device)[None, :]
    split = _split_dims(cache["k"], 2)
    k_c, v_c = [], []
    for lp, kc, vc in zip(params.layers, cache["k"], cache["v"]):
        a, (k_new, v_new) = attention(
            cfg,
            lp.attn,
            rmsnorm(x, lp.ln1, cfg.norm_eps),
            positions,
            k_cache=kc,
            v_cache=vc,
            k_pos=k_pos,
        )
        x = x + a
        x = x + _ffn(cfg, lp, rmsnorm(x, lp.ln2, cfg.norm_eps))[0]
        # roll the cache: drop oldest position, append the new one (a split
        # cache after the loop, every layer at once)
        k_c.append(k_new if split else k_new[:, 1:])
        v_c.append(v_new if split else v_new[:, 1:])
    x = rmsnorm(x, params.ln_f, cfg.norm_eps)
    logits = x @ params.unembed.to(cfg.dtype)
    if split:
        k_out, v_out = _roll_split(cache["k"], cache["v"], torch.stack(k_c), torch.stack(v_c))
    else:
        k_out, v_out = torch.stack(k_c), torch.stack(v_c)
    new_cache = {"k": k_out, "v": v_out, "pos": cache["pos"] + 1}
    return logits, new_cache


def loss_fn(cfg: LMConfig, params, batch: dict) -> torch.Tensor:
    params = cast_params(cfg, params)
    hidden, aux = forward(cfg, params, batch["tokens"])
    loss = chunked_ce(cfg, params, hidden, batch["labels"])
    return loss + 0.01 * aux
