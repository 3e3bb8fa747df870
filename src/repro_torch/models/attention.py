"""Attention: GQA with flash-style chunked softmax, KV caches, M-RoPE.

The chunked implementation (``chunked_attention`` -> ``models.flash``) is
the default for prefill: queries are processed in blocks with an
online-softmax accumulator over KV blocks, so the (S x S) score matrix
never materialises.

Decode (``decode_attention``) scores one new token against the whole cache,
grouped by KV head: the cache is never repeated to h heads.

Under tensor parallelism (``parallel.tp``, inside
``parallel.act_sharding.zero3`` with ``model`` over one rank) each rank
projects its heads from its ``wq`` block; K/V come out on the rank's KV
heads when they divide ``model``, else (``head_dim`` on ``model``, as the
rules fall back) they are assembled whole and each rank attends with the
KV heads of its query heads.  ``attn_output`` is row-parallel: one psum.
Decode over a sequence-sharded cache combines the ranks' softmax
statistics (:func:`decode_attention` with ``seq_axis``).

Where the reference asks an einsum for float32 results
(``preferred_element_type``), the port casts both operands to float32
first: products of bf16 values are exact in float32, so it is the same
arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.parallel import act_sharding, tp

NEG_INF = -2.0e38


def attention_init(gen, cfg, dtype=torch.float32, d_kv_model: int | None = None,
                   lead=(), device=None):
    """QKV/O projection params.  d_kv_model: source dim for K/V (cross-attn)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dk = d_kv_model or d
    dev = layers.on(gen, device)
    p = {
        "wq": layers.dense_init(gen, (d, h, hd), d, dtype, lead, dev),
        "wk": layers.dense_init(gen, (dk, kv, hd), dk, dtype, lead, dev),
        "wv": layers.dense_init(gen, (dk, kv, hd), dk, dtype, lead, dev),
        "wo": layers.dense_init(gen, (h, hd, d), h * hd, dtype, lead, dev),
    }
    if cfg.qkv_bias:
        z = lambda *s: torch.zeros(tuple(lead) + s, dtype=dtype, device=dev)
        p["bq"], p["bk"], p["bv"] = z(h, hd), z(kv, hd), z(kv, hd)
    return p


def _project(x, w, compute_dtype):
    """einsum("bsd,dhk->bshk") as one matmul."""
    b, s, _ = x.shape
    d, h, k = w.shape
    return (x @ w.to(compute_dtype).reshape(d, h * k)).reshape(b, s, h, k)


def _proj(x, params, w, b, compute_dtype):
    y = _project(x, params[w], compute_dtype)
    return y + params[b].to(compute_dtype) if b in params else y


def q_project(params, x, compute_dtype):
    """The queries of the rank's heads (all heads without TP)."""
    ax = _heads_axis(params)
    return _proj(tp.copy(x, ax), params, "wq", "bq", compute_dtype)


def kv_project(params, x_kv, compute_dtype):
    """K and V for the rank's query heads: its KV heads when they are on
    ``model``; else whole (``head_dim`` blocks assembled), entering the
    local compute."""
    ax = _heads_axis(params)
    return _kv(params, x_kv, tp.copy(x_kv, ax), ax, compute_dtype)


def _kv(params, x_kv, x_local, ax, compute_dtype):
    """:func:`kv_project` given ``x_local``, ``x_kv`` entering the local
    compute."""
    dim = act_sharding.tp_dim(params["wk"]) if ax is not None else None
    xin = x_local if dim is not None else x_kv
    k = _proj(xin, params, "wk", "bk", compute_dtype)
    v = _proj(xin, params, "wv", "bv", compute_dtype)
    if dim == 2:                                  # head_dim on 'model'
        k, v = tp.assemble(k, ax, 3), tp.assemble(v, ax, 3)
    if dim != 1:
        k, v = tp.copy(k, ax), tp.copy(v, ax)
    return k, v


def _heads_axis(params):
    """The ``model`` axis when the query heads are the rank's, else
    None."""
    dim = act_sharding.tp_dim(params["wq"])
    if dim is None:
        return None
    if dim != 1:
        raise ValueError("tensor-parallel attention needs the query heads "
                         "on 'model' (n_heads a multiple of its size)")
    return act_sharding.model_axis()


def qkv_project(params, x, x_kv, cfg, compute_dtype):
    ax = _heads_axis(params)
    xc = tp.copy(x, ax)
    q = _proj(xc, params, "wq", "bq", compute_dtype)
    k, v = _kv(params, x_kv, xc if x_kv is x else tp.copy(x_kv, ax), ax,
               compute_dtype)
    return q, k, v


def local_kv(k, cfg, h_loc: int):
    """The KV heads (b, s, kv, hd) that the rank's ``h_loc`` query heads
    read, when ``k`` holds all ``cfg.n_kv_heads``; ``k`` itself when it
    already holds the rank's (or the rank has every query head)."""
    if h_loc == cfg.n_heads or k.shape[2] != cfg.n_kv_heads:
        return k
    rep = cfg.n_heads // cfg.n_kv_heads
    first = act_sharding.model_axis().index * h_loc
    if h_loc % rep == 0 or rep % h_loc == 0:      # a contiguous group
        return k[:, :, first // rep:(first + h_loc - 1) // rep + 1]
    idx = (first + torch.arange(h_loc, device=k.device)) // rep
    return k.index_select(2, idx)


def _repeat_kv(k, n_heads):
    """Broadcast kv heads up to n_heads for grouped-query attention."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def chunked_attention(q, k, v, *, causal: bool, chunk_q: int, chunk_kv: int,
                      q_offset: int = 0):
    """Flash attention with its memory-exact backward
    (``repro_torch.models.flash``)."""
    from repro_torch.models.flash import flash_attention
    return flash_attention(q, k, v, causal=causal, chunk_q=chunk_q,
                           chunk_kv=chunk_kv, q_offset=q_offset)


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference O(S^2)-memory attention (tests/small shapes only)."""
    h = q.shape[2]
    k = _repeat_kv(k, h)
    v = _repeat_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    if causal:
        qp = q_offset + torch.arange(q.shape[1], device=q.device)
        kp = torch.arange(k.shape[1], device=q.device)
        s = torch.where(kp[None, None, None, :] <= qp[None, None, :, None],
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def decode_attention(q, k_cache, v_cache, cache_len, seq_axis=None):
    """One-token decode: q (b, 1, h, hd) vs cache (b, S, kvh, hd).

    GQA is computed *grouped* -- the cache is never repeated to h heads.
    ``cache_len``: number of valid cache entries (the new token's K/V must
    already be written at position cache_len - 1).  With ``seq_axis`` the
    cache is the rank's block of the sequence: scores are masked by global
    position, then the row max is a pmax and the exp-sum and the context
    psums over the axis.
    """
    b, _, h, hd = q.shape
    S, g = k_cache.shape[1], k_cache.shape[2]
    rep = h // g
    qg = q.reshape(b, g, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float()) \
        * (hd ** -0.5)
    valid = tp.offset(S, seq_axis) + torch.arange(
        S, device=q.device)[None, None, None, :] < cache_len
    s = torch.where(valid, s, NEG_INF)
    if not tp.active(seq_axis):
        p = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype), v_cache)
        return ctx.reshape(b, 1, h, hd)
    m = tp.pmax(s.amax(dim=-1, keepdim=True), seq_axis)
    e = torch.exp(s - m)
    p = e / tp.psum(e.sum(dim=-1, keepdim=True), seq_axis)
    ctx = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype), v_cache)
    return tp.psum(ctx, seq_axis).reshape(b, 1, h, hd)


def attn_output(params, ctx, compute_dtype):
    """einsum("bshk,hkd->bsd") as one matmul; row-parallel (one psum)
    when the rank holds its heads of ``wo`` (a context of every head is
    cut to the rank's first)."""
    wo = params["wo"]
    ax = act_sharding.tp_axis(wo, 0)
    if ax is not None and ctx.shape[2] != wo.shape[0]:
        ctx = tp.split(ctx, ax, 2)
    b, s, h, k = ctx.shape
    w = wo.to(compute_dtype).reshape(h * k, -1)
    return tp.psum(ctx.reshape(b, s, h * k) @ w, ax)
