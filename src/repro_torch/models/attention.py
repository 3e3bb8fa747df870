"""Attention: GQA with flash-style chunked softmax, KV caches, M-RoPE.

The chunked implementation (``chunked_attention`` -> ``models.flash``) is
the default for prefill: queries are processed in blocks with an
online-softmax accumulator over KV blocks, so the (S x S) score matrix
never materialises.

Decode (``decode_attention``) scores one new token against the whole cache,
grouped by KV head: the cache is never repeated to h heads.

Where the reference asks an einsum for float32 results
(``preferred_element_type``), the port casts both operands to float32
first: products of bf16 values are exact in float32, so it is the same
arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers

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


def qkv_project(params, x, x_kv, cfg, compute_dtype):
    q = _project(x, params["wq"], compute_dtype)
    k = _project(x_kv, params["wk"], compute_dtype)
    v = _project(x_kv, params["wv"], compute_dtype)
    if "bq" in params:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    return q, k, v


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


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token decode: q (b, 1, h, hd) vs cache (b, S, kvh, hd).

    GQA is computed *grouped* -- the cache is never repeated to h heads.
    ``cache_len``: number of valid cache entries (the new token's K/V must
    already be written at position cache_len - 1).
    """
    b, _, h, hd = q.shape
    S, g = k_cache.shape[1], k_cache.shape[2]
    rep = h // g
    qg = q.reshape(b, g, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k_cache.float()) \
        * (hd ** -0.5)
    valid = torch.arange(S, device=q.device)[None, None, None, :] < cache_len
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype), v_cache)
    return ctx.reshape(b, 1, h, hd)


def attn_output(params, ctx, compute_dtype):
    """einsum("bshk,hkd->bsd") as one matmul."""
    b, s, h, k = ctx.shape
    wo = params["wo"].to(compute_dtype).reshape(h * k, -1)
    return ctx.reshape(b, s, h * k) @ wo
