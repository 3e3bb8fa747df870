"""Analytic FLOP/byte model for the roofline compute & memory terms.

A copy of ``repro.analysis.flops`` (pure arithmetic over ``ModelConfig``):
executed FLOPs and HBM bytes from exact per-layer formulas that mirror the
code in ``models/`` (every matmul term accounted).

Conventions: a matmul (m, k) @ (k, n) costs 2mkn FLOPs.  Chunked causal
attention is charged the FULL T x S rectangle (the reference's flash
computes every (q-block, kv-block) pair; the port's skips the blocks that
lie wholly after a causal q block, so it executes fewer than counted).
``step_flops`` charges a train step 5x the forward under two-level remat
(one forward, two recomputes, a backward of two forwards), 3x without;
the useful work of a step is 3x (``fwd_flops``).
"""
from __future__ import annotations

import math

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import expert_capacity
from repro_torch.models.registry import SHAPES


# -- per-layer forward FLOPs ---------------------------------------------------
def attn_flops(cfg, T, S_ctx, *, d_in=None):
    d = d_in or cfg.d_model
    h, hd, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    qkv = 2 * T * d * (h * hd) + 2 * (2 * T * d * (kv * hd))
    core = 2 * T * S_ctx * h * hd * 2          # QK^T and PV
    out = 2 * T * (h * hd) * d
    return qkv + core + out


def mlp_flops(cfg, T, ff=None):
    return 3 * (2 * T * cfg.d_model * (ff or cfg.d_ff))


def moe_flops(cfg, T, seq_len):
    router = 2 * T * cfg.d_model * cfg.n_experts
    cap = expert_capacity(cfg, seq_len)
    batch_rows = max(1, T // seq_len)
    routed_tokens = batch_rows * cfg.n_experts * cap   # capacity-padded
    experts = 3 * (2 * routed_tokens * cfg.d_model * cfg.d_ff)
    shared = (mlp_flops(cfg, T, cfg.n_shared_experts * cfg.d_ff)
              if cfg.n_shared_experts else 0)
    return router + experts + shared


def mamba1_flops(cfg, T):
    d, din, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    k = cfg.ssm_conv
    proj = 2 * T * d * (2 * din)
    conv = 2 * T * din * k
    xproj = 2 * T * din * (r + 2 * n)
    dt = 2 * T * r * din
    scan = 4 * math.log2(max(cfg.ssm_chunk, 2)) * T * din * n \
        + 10 * T * din * n
    y = 2 * T * din * n
    out = 2 * T * din * d
    return proj + conv + xproj + dt + scan + y + out


def mamba2_flops(cfg, T):
    d, din, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    proj = 2 * T * d * (2 * din)
    conv = 2 * T * din * cfg.ssm_conv
    bc = 2 * (2 * T * d * n)
    dt = 2 * T * d * H
    if getattr(cfg, "ssm_impl", "scan") == "ssd":
        # dual form: (QxQ) score matmul + masked-decay combine + M@x
        # matmul + state update / inter-chunk einsums
        core = (2 * T * Q * n                 # C.B^T scores
                + 3 * T * Q * H               # decay/mask combine
                + 2 * T * Q * H * Pd          # M @ x
                + 6 * T * H * Pd * n)         # state update + inter + D
    else:
        core = (4 * math.log2(max(Q, 2)) * T * H * Pd * n
                + 10 * T * H * Pd * n + 2 * T * H * Pd * n)
    out = 2 * T * din * d
    return proj + conv + bc + dt + core + out


def shared_block_flops(cfg, T, S_ctx):
    inproj = 2 * T * (2 * cfg.d_model) * cfg.d_model
    return inproj + attn_flops(cfg, T, S_ctx) + mlp_flops(cfg, T)


def head_flops(cfg, T):
    return 2 * T * cfg.d_model * cfg.vocab_size


# -- whole-step forward FLOPs -----------------------------------------------------
def fwd_flops(cfg: ModelConfig, T: int, S_ctx: int, *, with_head_tokens=None):
    """One forward pass over T tokens with context length S_ctx."""
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        per = attn_flops(cfg, T, S_ctx) + mlp_flops(cfg, T)
        total = L * per
        if cfg.family == "vlm":
            total += 2 * T * cfg.d_model * cfg.d_model  # adapter
    elif cfg.family == "moe":
        total = L * (attn_flops(cfg, T, S_ctx) + moe_flops(cfg, T, S_ctx))
    elif cfg.family == "ssm":
        f = mamba1_flops if cfg.ssm_variant == "mamba1" else mamba2_flops
        total = L * f(cfg, T)
    elif cfg.family == "hybrid":
        groups = -(-L // cfg.hybrid_attn_every)
        total = L * mamba2_flops(cfg, T) \
            + groups * shared_block_flops(cfg, T, S_ctx)
    elif cfg.family == "encdec":
        enc = cfg.n_encoder_layers * (attn_flops(cfg, T, S_ctx)
                                      + mlp_flops(cfg, T))
        # decoder: self attention + cross attention (ctx = encoder length)
        dec = cfg.n_layers * (attn_flops(cfg, T, S_ctx)
                              + attn_flops(cfg, T, S_ctx)
                              + mlp_flops(cfg, T))
        total = enc + dec
    else:
        raise ValueError(cfg.family)
    head_T = with_head_tokens if with_head_tokens is not None else T
    return total + head_flops(cfg, head_T)


def step_flops(cfg: ModelConfig, shape_name: str) -> dict:
    """Executed-FLOPs estimate for the dry-run cell (global, all chips)."""
    sh = SHAPES[shape_name]
    S, B = sh["seq_len"], sh["global_batch"]
    if sh["kind"] == "train":
        f = fwd_flops(cfg, B * S, S)
        # bwd = 2x fwd; two-level remat recomputes fwd twice (group +
        # per-layer checkpoints -- see transformer.scan_layers_remat)
        mult = 5.0 if cfg.remat else 3.0
        return {"fwd": f, "total": mult * f}
    if sh["kind"] == "prefill":
        f = fwd_flops(cfg, B * S, S, with_head_tokens=B)  # head on last tok
        return {"fwd": f, "total": f}
    # decode: T = B tokens, context = S
    f = fwd_flops(cfg, B, S)
    return {"fwd": f, "total": f}


# -- whole-step HBM bytes (napkin, documented) -------------------------------------
def step_bytes(cfg: ModelConfig, shape_name: str, n_params: float) -> dict:
    """HBM traffic estimate (global).  Terms:

    params: train = fwd read + bwd read + remat read (4B f32 each) + grad
            write (4B) + adafactor rw (~9B) ~= 25 B/param;
            serve = one read of every param (4B f32 as stored).
    acts:   K_rw passes of (T x d_model) bf16 per layer; K_rw = 12 train
            (write+read of ~3 fused groups, fwd+bwd), 4 serve.
    cache:  decode reads the whole KV/SSM cache once + writes one row;
            prefill writes it once.
    logits: chunked CE: write+read f32 chunks, ~3 passes train, 1 serve.
    """
    sh = SHAPES[shape_name]
    S, B = sh["seq_len"], sh["global_batch"]
    T = B * (1 if sh["kind"] == "decode" else S)
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size

    if sh["kind"] == "train":
        params = 25.0 * n_params
        acts = 12.0 * L * T * d * 2.0
        logits = 3.0 * T * V * 4.0  # chunked: full traffic, one chunk live
        cache = 0.0
    else:
        params = 4.0 * n_params
        acts = 4.0 * L * T * d * 2.0
        logits = 1.0 * (B * V * 4.0)
        if sh["kind"] == "decode":
            if cfg.family in ("dense", "moe", "vlm", "encdec"):
                kvh, hd = cfg.n_kv_heads, cfg.head_dim
                cache = L * B * S * kvh * hd * 2 * 2.0  # read k+v bf16
            elif cfg.family == "ssm":
                n_state = cfg.ssm_state
                cache = L * B * cfg.d_inner * n_state * 4.0 * 2
            else:  # hybrid
                groups = -(-L // cfg.hybrid_attn_every)
                cache = (groups * B * S * cfg.n_kv_heads * cfg.head_dim
                         * 2 * 2.0
                         + L * B * cfg.ssm_heads * cfg.ssm_head_dim
                         * cfg.ssm_state * 4.0 * 2)
        else:  # prefill writes the cache once
            if cfg.family in ("dense", "moe", "vlm", "encdec"):
                cache = L * B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
            else:
                cache = L * B * d * 4.0
    total = params + acts + logits + cache
    return {"params": params, "acts": acts, "logits": logits,
            "cache": cache, "total": total}
