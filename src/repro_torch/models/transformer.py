"""Decoder-only LM covering dense / MoE / SSM / hybrid / VLM families.

The reference's structure (``repro.models.transformer``): layers are
*stacked* (every leaf gains a leading L axis).  The reference iterates the
stack with ``lax.scan`` under two-level remat; here a Python loop walks
it (:func:`scan_layers_remat`), each stacked leaf unbound once into its L
layer slices, so that a backward stacks the L slices' gradients once.  In
training (``cfg.remat`` and grad enabled) the loop is checkpointed at the
reference's two levels, per group of layers and per layer
(``torch.utils.checkpoint``, non-reentrant), which changes no value.  The
reference's sharding hooks (``parallel.act_sharding``: ``constrain``,
``gather_layer_params``) are called at its places; without a registered
mesh they are identities.  Inside ``act_sharding.zero3`` (a sharded train
step, or the serving engine on a mesh) ``gather_layer_params`` gathers
each layer's weights from the rank's blocks (inside the per-layer
checkpoint, so the backward gathers again), keeping their ``model``
blocks: the blocks compute tensor-parallel (``models.attention``,
``models.moe``, ``models.layers``), and ``init_cache(mesh=)`` lays the
caches out by ``parallel.sharding.cache_specs``.

Three entry points:
  * ``forward``      -- full-sequence logits.
  * ``prefill``      -- serving: full-sequence pass that also returns caches.
  * ``decode_step``  -- serving: one token against the caches (the smart
                        update of the LM world: only the new row computes).

Caches are stacked over layers, as in the reference.  ``prefill`` writes
the prompt's K/V at position 0 and ``decode_step`` writes each layer's
slice of the stacked cache in place and returns the same dict: a caller
that needs the cache from before a step copies it first.  The serving
path never runs under a checkpoint.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models import attention, layers, mamba, moe
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import act_sharding, tp
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.act_sharding import (constrain, gather_layer_params,
                                              unconstrain)
from repro_torch.tree import flatten, unflatten


def _cdt(cfg):
    return layers._dtype(cfg.dtype)


def _pdt(cfg):
    return layers._dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layers_init(gen, cfg, pdt, dev):
    """The stacked params of all ``cfg.n_layers`` blocks, drawn at once."""
    lead = (cfg.n_layers,)
    p = {}
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        p["ln1"] = layers.rmsnorm_init(cfg.d_model, pdt, dev, lead)
        p["attn"] = attention.attention_init(gen, cfg, pdt, lead=lead,
                                             device=dev)
        p["ln2"] = layers.rmsnorm_init(cfg.d_model, pdt, dev, lead)
        if cfg.family == "moe":
            p["moe"] = moe.moe_init(gen, cfg, pdt, lead, dev)
        else:
            p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, pdt, lead,
                                       dev)
    elif cfg.family == "ssm":
        p["ln1"] = layers.rmsnorm_init(cfg.d_model, pdt, dev, lead)
        p["ssm"] = (mamba.mamba1_init(gen, cfg, pdt, lead, dev)
                    if cfg.ssm_variant == "mamba1"
                    else mamba.mamba2_init(gen, cfg, pdt, lead, dev))
    elif cfg.family == "hybrid":
        p["ln1"] = layers.rmsnorm_init(cfg.d_model, pdt, dev, lead)
        p["ssm"] = mamba.mamba2_init(gen, cfg, pdt, lead, dev)
    else:
        raise ValueError(cfg.family)
    return p


def _shared_attn_init(gen, cfg, pdt, dev):
    """Zamba2-style shared attention+MLP block (weights reused at each
    invocation).  Input is concat([x, x_embed]) -> d_model projection."""
    return {
        "in_proj": layers.dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                     2 * cfg.d_model, pdt, device=dev),
        "ln1": layers.rmsnorm_init(cfg.d_model, pdt, dev),
        "attn": attention.attention_init(gen, cfg, pdt, device=dev),
        "ln2": layers.rmsnorm_init(cfg.d_model, pdt, dev),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, pdt, device=dev),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random params in the reference's tree, drawn from ``gen`` on its
    device (or on ``device``: ``"meta"`` gives the tree's shapes and dtypes
    and allocates nothing)."""
    pdt = _pdt(cfg)
    dev = layers.on(gen, device)
    params = {
        "layers": _layers_init(gen, cfg, pdt, dev),
        "final_norm": layers.rmsnorm_init(cfg.d_model, pdt, dev),
    }
    if cfg.embed_inputs or cfg.tie_embeddings:
        params["embed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            pdt, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.lm_head_init(gen, cfg.d_model,
                                                cfg.vocab_size, pdt, dev)
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        params["shared_attn"] = _shared_attn_init(gen, cfg, pdt, dev)
    if cfg.family == "vlm":
        # stub frontend adapter: maps provided patch embeddings to d_model
        params["vision_adapter"] = layers.dense_init(
            gen, (cfg.d_model, cfg.d_model), cfg.d_model, pdt, device=dev)
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in flatten(params)[1])


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in flatten(params)[1])


def unstack(tree, n: int) -> list:
    """The ``n`` slices along the leading (layer) axis of every leaf, as
    ``n`` trees of views (``torch.unbind``: one backward node per leaf),
    each keeping its leaf's ``model`` dimension
    (``act_sharding.mark_slices``)."""
    _, leaves = flatten(tree)
    per = [torch.unbind(x, 0) for x in leaves]
    for x, parts in zip(leaves, per):
        act_sharding.mark_slices(x, parts)
    return [unflatten(tree, [p[i] for p in per]) for i in range(n)]


def _auto_group(L: int) -> int:
    """Largest divisor of L that is <= 8 (group size for two-level remat)."""
    for g in range(min(8, L), 0, -1):
        if L % g == 0:
            return g
    return 1


def remat_on(cfg) -> bool:
    """Checkpoint the layers: ``cfg.remat`` and a backward may follow."""
    return cfg.remat and torch.is_grad_enabled()


def checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward (no layer
    draws random numbers, so no RNG state is stashed)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def scan_layers_remat(body, x, layer_params: list, cfg):
    """``x = body(x, lp)`` for each layer's params in turn.  Under
    :func:`remat_on`, the reference's two-level remat: a checkpoint around
    each group of :func:`_auto_group` layers and one around each layer, so
    only the group boundaries live across the whole stack."""
    if not remat_on(cfg):
        for lp in layer_params:
            x = body(x, lp)
        return x
    g = _auto_group(len(layer_params))

    def group(h, lps):
        for lp in lps:
            h = checkpoint(body, h, lp)
        return h

    for i in range(0, len(layer_params), g):
        x = checkpoint(group, x, layer_params[i:i + g])
    return x


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _quantize_kv(x):
    """(b, s, kv, hd) -> int8 values + per-(position, kv-head) scale."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(x / torch.clamp(scale, min=1e-8)), -127, 127)
    return q.to(torch.int8), scale.to(x.dtype)


def _dequantize_kv(q, scale, dtype):
    return q.to(dtype) * scale.to(dtype)


def _write(buf, x, pos, seq_axis=None):
    """``lax.dynamic_update_slice_in_dim(buf, x, pos, axis=1)`` in place:
    the start clamped so that the update fits, as XLA clamps it.  With
    ``seq_axis`` ``buf`` is the rank's block of the sequence, and the rank
    writes the positions its block holds."""
    n, size = x.shape[1], buf.shape[1]
    lo = tp.offset(size, seq_axis)
    total = size * seq_axis.size if tp.active(seq_axis) else size
    start = max(0, min(int(pos), total - n))
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        buf[:, a - lo:b - lo] = x[:, a - start:b - start].to(buf.dtype)


def _attend(q, k, v, cfg, cdt, cache, pos, seq_axis=None):
    """Attention of the block on the rank's query heads, writing the new
    K/V into ``cache`` (in place) when there is one; returns the context
    (of every head after a decode over a sequence-sharded cache)."""
    kl = attention.local_kv(k, cfg, q.shape[2])
    vl = attention.local_kv(v, cfg, q.shape[2])
    prefill = lambda: attention.chunked_attention(
        q, kl, vl, causal=True, chunk_q=cfg.attn_chunk_q,
        chunk_kv=cfg.attn_chunk_kv)
    if cache is None:
        return prefill()
    if len(cache) == 4:                       # int8-quantized cache
        kc, vc, ks, vs = cache
        kq, ksc = _quantize_kv(k)
        vq, vsc = _quantize_kv(v)
        for buf, x in ((kc, kq), (vc, vq), (ks, ksc), (vs, vsc)):
            _write(buf, x, pos, seq_axis)
        if q.shape[1] != 1:
            return prefill()
        kc, vc = _dequantize_kv(kc, ks, cdt), _dequantize_kv(vc, vs, cdt)
    else:
        kc, vc = cache
        _write(kc, k, pos, seq_axis)
        _write(vc, v, pos, seq_axis)
        if q.shape[1] != 1:
            # prefill: queries attend causally within the prompt only
            return prefill()
    if tp.active(seq_axis):                   # every head, every block
        q = tp.assemble(q, act_sharding.model_axis(), 2)
        return attention.decode_attention(q, kc, vc, pos + 1, seq_axis)
    return attention.decode_attention(q, attention.local_kv(kc, cfg,
                                                            q.shape[2]),
                                      attention.local_kv(vc, cfg,
                                                         q.shape[2]),
                                      pos + 1)


def _attn_mlp_block(p, x, cfg, cdt, positions, *, cache=None, pos=None,
                    use_moe=False, seq_axis=None):
    """Pre-norm attention + MLP/MoE.  cache: (k, v) or (k, v, k_scale,
    v_scale) views of this layer's cache, written in place."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = attention.qkv_project(p["attn"], h, h, cfg, cdt)
    if cfg.mrope_sections is not None:
        q = layers.apply_mrope(q, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = layers.apply_mrope(k, positions, cfg.rope_theta,
                               cfg.mrope_sections)
    else:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    ctx = _attend(q, k, v, cfg, cdt, cache, pos, seq_axis)
    x = x + attention.attn_output(p["attn"], ctx.to(cdt), cdt)

    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if use_moe:
        return x + moe.moe_layer(p["moe"], h, cfg, cdt)
    return x + layers.mlp(p["mlp"], h, cdt)


def _ssm_block(p, x, cfg, cdt, *, state=None):
    """Pre-norm SSM block; with ``state`` = (h0, conv0) it also returns
    the new (h, conv)."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    fwd = (mamba.mamba1_forward if cfg.ssm_variant == "mamba1"
           else mamba.mamba2_forward)
    if state is None:
        return x + fwd(p["ssm"], h, cfg, cdt), None
    y, h_new, conv_new = fwd(p["ssm"], h, cfg, cdt, h0=state[0],
                             conv0=state[1], return_state=True)
    return x + y, (h_new, conv_new)


def _shared_block(p, x, x0, cfg, cdt, positions, *, cache=None, pos=None,
                  seq_axis=None):
    """Zamba2 shared attention block on concat([x, x0])."""
    inp = torch.cat([x, x0], dim=-1) @ p["in_proj"].to(cdt)
    h = layers.rmsnorm(p["ln1"], inp, cfg.norm_eps)
    q, k, v = attention.qkv_project(p["attn"], h, h, cfg, cdt)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    ctx = _attend(q, k, v, cfg, cdt, cache, pos, seq_axis)
    y = attention.attn_output(p["attn"], ctx.to(cdt), cdt)
    y = y + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], y, cfg.norm_eps),
                       cdt)
    return x + y


# ---------------------------------------------------------------------------
# backbone traversal
# ---------------------------------------------------------------------------
def _embed_inputs(params, batch, cfg, cdt):
    if cfg.family == "vlm":
        x = batch["embeds"].to(cdt) @ params["vision_adapter"].to(cdt)
        positions = batch["positions"]          # (3, b, s) M-RoPE ids
    else:
        x = layers.embed(params["embed"], batch["tokens"], cdt)
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None] \
                .expand(x.shape[:2])
    return x, positions


def _ssm_layer(lp, x, cfg, cdt, caches, li):
    """One SSM block; with caches, its state is read from and written back
    to layer ``li`` of the stacked ``h``/``conv`` caches."""
    if caches is None:
        return _ssm_block(lp, x, cfg, cdt)[0]
    x, (h_new, conv_new) = _ssm_block(
        lp, x, cfg, cdt, state=(caches["h"][li], caches["conv"][li]))
    caches["h"][li] = h_new
    caches["conv"][li] = conv_new
    return x


def _run_layers(params, x, cfg, cdt, positions, caches=None, pos=None):
    """Walk the stacked layers.  caches=None -> training (no cache IO,
    :func:`scan_layers_remat`); otherwise a dict of stacked caches that is
    read and rewritten in place.  In training under sequence parallelism
    (``act_sharding.sequence_parallel``) the residual between layers is
    the rank's sequence block: each layer assembles it on entry and cuts
    its output (``constrain``).  The SSM and hybrid stacks carry an SSM
    residual (``residual_ssm``), the whole sequence on every rank: the
    scan runs over it in order."""
    L = cfg.n_layers
    lps = unstack(params["layers"], L)
    role = "residual_ssm" if cfg.family in ("ssm", "hybrid") else "residual"
    sp = caches is None and act_sharding.sequence_parallel(x.shape, role)
    sharded = act_sharding.sharded()
    if cfg.family in ("dense", "moe", "vlm"):
        use_moe = cfg.family == "moe"
        if caches is None:
            def body(h, lp):
                h = unconstrain(h, sp)
                lp = gather_layer_params(lp)
                return constrain(_attn_mlp_block(lp, h, cfg, cdt, positions,
                                                 use_moe=use_moe))

            return unconstrain(scan_layers_remat(body, constrain(x), lps,
                                                 cfg), sp), None
        names = (["k", "v", "k_scale", "v_scale"]
                 if "k_scale" in caches else ["k", "v"])
        seq_axis = act_sharding.cache_seq_axis(caches["k"])
        for li in range(L):
            if x.shape[1] != 1:          # prefill (decode: no hook)
                x = constrain(x)
            lp = gather_layer_params(lps[li]) if sharded else lps[li]
            x = _attn_mlp_block(lp, x, cfg, cdt, positions,
                                cache=tuple(caches[n][li] for n in names),
                                pos=pos, use_moe=use_moe, seq_axis=seq_axis)
        return x, caches

    if cfg.family == "ssm":
        if caches is None:
            def body(h, lp):
                h = unconstrain(h, sp)
                lp = gather_layer_params(lp)
                return constrain(_ssm_block(lp, h, cfg, cdt)[0], role)

            return unconstrain(scan_layers_remat(body, constrain(x, role),
                                                 lps, cfg), sp), None
        for li in range(L):
            x = _ssm_layer(gather_layer_params(lps[li]), constrain(x, role),
                           cfg, cdt, caches, li)
        return x, caches

    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every or L + 1
        n_groups = -(-L // every)
        x0 = x
        li = 0
        if caches is None:
            x = constrain(x, role)
        for g in range(n_groups):
            size = min(every, L - g * every)
            if caches is None:
                x = scan_layers_remat(
                    lambda h, lp: constrain(_ssm_block(
                        lp, unconstrain(h, sp), cfg, cdt)[0], role),
                    x, lps[li:li + size], cfg)
                # shared attention block after each group (rematted: its
                # flash residuals would otherwise persist per invocation)
                shared = lambda h, h0, p: constrain(_shared_block(
                    p, unconstrain(h, sp), h0, cfg, cdt, positions), role)
                x = (checkpoint(shared, x, x0, params["shared_attn"])
                     if remat_on(cfg) else shared(x, x0,
                                                  params["shared_attn"]))
                li += size
                continue
            for _ in range(size):
                x = _ssm_layer(lps[li], constrain(x, role), cfg, cdt, caches,
                               li)
                li += 1
            # shared attention block after each group
            x = _shared_block(params["shared_attn"], x, x0, cfg, cdt,
                              positions, cache=(caches["k"][g],
                                                caches["v"][g]), pos=pos,
                              seq_axis=act_sharding.cache_seq_axis(
                                  caches["k"]))
        return (unconstrain(x, sp), None) if caches is None else (x, caches)

    raise ValueError(cfg.family)


def _logits(params, x, cfg, vocab_block=False):
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x, vocab_block)
    return layers.lm_head(params["lm_head"], x, vocab_block)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------
def forward_features(params, batch, cfg: ModelConfig):
    """Backbone pass: final-normed features (b, s, d)."""
    cdt = _cdt(cfg)
    x, positions = _embed_inputs(params, batch, cfg, cdt)
    x, _ = _run_layers(params, x, cfg, cdt, positions)
    return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def head(params, x, cfg: ModelConfig, vocab_block: bool = False):
    """Logits of the final features ``x`` (``vocab_block``: the rank's
    vocab columns when they are on ``model``, ``layers.lm_head``)."""
    return _logits(params, x, cfg, vocab_block)


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence logits (b, s, vocab) in f32."""
    return _logits(params, forward_features(params, batch, cfg), cfg)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, dtype=None,
               device=None, mesh=None) -> dict:
    """Allocate decode caches (stacked over layers) on ``device``; with
    ``mesh`` this rank's block of each under ``parallel.sharding
    .cache_specs`` (each leaf remembers its spec)."""
    if mesh is not None:
        shapes = init_cache(cfg, batch_size, max_len, dtype, "meta")
        return act_sharding.cache_blocks(
            shapes, shd.cache_specs(cfg, shapes, mesh), mesh, device)
    dtype = dtype or _cdt(cfg)
    kvh, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    if cfg.family in ("dense", "moe", "vlm") \
            and cfg.kv_cache_dtype == "int8":
        # quantized serving cache: halves the dominant decode memory term
        return {
            "k": z((L, batch_size, max_len, kvh, hd), torch.int8),
            "v": z((L, batch_size, max_len, kvh, hd), torch.int8),
            "k_scale": z((L, batch_size, max_len, kvh, 1), dtype),
            "v_scale": z((L, batch_size, max_len, kvh, 1), dtype),
        }
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        return {
            "k": z((L, batch_size, max_len, kvh, hd), dtype),
            "v": z((L, batch_size, max_len, kvh, hd), dtype),
        }
    if cfg.family == "ssm":
        din, n = cfg.d_inner, cfg.ssm_state
        shp = ((L, batch_size, din, n) if cfg.ssm_variant == "mamba1"
               else (L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim, n))
        return {
            "h": z(shp, torch.float32),
            "conv": z((L, batch_size, cfg.ssm_conv - 1, cfg.d_inner), dtype),
        }
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        n_groups = -(-cfg.n_layers // every)
        return {
            "h": z((L, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                    cfg.ssm_state), torch.float32),
            "conv": z((L, batch_size, cfg.ssm_conv - 1, cfg.d_inner), dtype),
            "k": z((n_groups, batch_size, max_len, kvh, hd), dtype),
            "v": z((n_groups, batch_size, max_len, kvh, hd), dtype),
        }
    raise ValueError(cfg.family)


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """Process the prompt; returns (last_token_logits, caches)."""
    cdt = _cdt(cfg)
    x, positions = _embed_inputs(params, batch, cfg, cdt)
    mesh = act_sharding.sharded_mesh()
    caches = init_cache(cfg, act_sharding.global_batch(x.shape[0]), max_len,
                        device=x.device, mesh=mesh)
    x, caches = _run_layers(params, x, cfg, cdt, positions, caches=caches,
                            pos=0)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x[:, -1:], cfg), caches


def decode_step(params, batch, caches, pos, cfg: ModelConfig):
    """One decode step.  batch carries tokens (b, 1) (or embeds for vlm);
    ``pos`` is the write position (= current cache length).  ``caches``
    is updated in place and returned."""
    cdt = _cdt(cfg)
    if cfg.family == "vlm":
        x = batch["embeds"].to(cdt) @ params["vision_adapter"].to(cdt)
        positions = batch["positions"]
    else:
        x = layers.embed(params["embed"], batch["tokens"], cdt)
        positions = torch.full(x.shape[:2], int(pos), dtype=torch.int32,
                               device=x.device)
    x, caches = _run_layers(params, x, cfg, cdt, positions, caches=caches,
                            pos=pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg), caches
