"""Encoder-decoder transformer (seamless-m4t backbone).

The port of ``repro.models.encdec``.  The modality frontend is a stub, as
in the reference: ``batch["src_embeds"]`` carries precomputed speech-frame
embeddings (b, s_src, d_model).  The bidirectional encoder and the causal
text decoder with cross-attention are stacked layers walked by
``transformer.scan_layers_remat`` (checkpointed in training), with the
reference's sharding hooks at its places.  Decode
caches split into self-attention caches (``k``, ``v``: written in place
by each step) and cross-attention K/V (``xk``, ``xv``: computed once from
the encoder output by ``prefill``; decode steps never touch them).  The
cross-attention projects with ``wq``/``wk``/``wv`` alone, no bias and no
RoPE, as the reference does.  Under tensor parallelism both attentions and
the MLP compute on the rank's heads and columns (``models.attention``,
``models.layers``), and in training the residuals between layers are the
rank's sequence blocks (``parallel.act_sharding.constrain``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (_cdt, _pdt, _write,
                                            scan_layers_remat, unstack)
from repro_torch.parallel import act_sharding
from repro_torch.parallel.act_sharding import (constrain, gather_layer_params,
                                              unconstrain)


def _enc_layers_init(gen, cfg, pdt, dev):
    lead = (cfg.n_encoder_layers,)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, pdt, dev, lead),
        "attn": attention.attention_init(gen, cfg, pdt, lead=lead,
                                         device=dev),
        "ln2": layers.rmsnorm_init(cfg.d_model, pdt, dev, lead),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, pdt, lead, dev),
    }


def _dec_layers_init(gen, cfg, pdt, dev):
    lead = (cfg.n_layers,)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, pdt, dev, lead),
        "self_attn": attention.attention_init(gen, cfg, pdt, lead=lead,
                                              device=dev),
        "ln_x": layers.rmsnorm_init(cfg.d_model, pdt, dev, lead),
        "cross_attn": attention.attention_init(gen, cfg, pdt, lead=lead,
                                               device=dev),
        "ln2": layers.rmsnorm_init(cfg.d_model, pdt, dev, lead),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, pdt, lead, dev),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random params in the reference's tree, drawn from ``gen`` on its
    device (or on ``device``; ``"meta"`` allocates nothing)."""
    pdt = _pdt(cfg)
    dev = layers.on(gen, device)
    return {
        "encoder": _enc_layers_init(gen, cfg, pdt, dev),
        "enc_norm": layers.rmsnorm_init(cfg.d_model, pdt, dev),
        "decoder": _dec_layers_init(gen, cfg, pdt, dev),
        "final_norm": layers.rmsnorm_init(cfg.d_model, pdt, dev),
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, pdt,
                                   dev),
        "lm_head": layers.lm_head_init(gen, cfg.d_model, cfg.vocab_size,
                                       pdt, dev),
    }


def _positions(x, start=0):
    return (start + torch.arange(x.shape[1], device=x.device))[None] \
        .expand(x.shape[:2])


def _flash(q, k, v, cfg, causal):
    """Flash attention of the rank's query heads (all without TP)."""
    k = attention.local_kv(k, cfg, q.shape[2])
    v = attention.local_kv(v, cfg, q.shape[2])
    return attention.chunked_attention(q, k, v, causal=causal,
                                       chunk_q=cfg.attn_chunk_q,
                                       chunk_kv=cfg.attn_chunk_kv)


def encode(params, src_embeds, cfg: ModelConfig):
    """Bidirectional encoder over stub frame embeddings."""
    cdt = _cdt(cfg)
    x = src_embeds.to(cdt)
    positions = _positions(x)
    sp = act_sharding.sequence_parallel(x.shape)

    def body(h, lp):
        h = unconstrain(h, sp)
        lp = gather_layer_params(lp)
        z = layers.rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = attention.qkv_project(lp["attn"], z, z, cfg, cdt)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        ctx = _flash(q, k, v, cfg, causal=False)
        h = h + attention.attn_output(lp["attn"], ctx.to(cdt), cdt)
        z = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
        return constrain(h + layers.mlp(lp["mlp"], z, cdt))

    x = scan_layers_remat(body, constrain(x), unstack(
        params["encoder"], cfg.n_encoder_layers), cfg)
    return layers.rmsnorm(params["enc_norm"], unconstrain(x, sp),
                          cfg.norm_eps)


def _cross(lp):
    """The cross-attention's projections without their biases."""
    return {k: v for k, v in lp["cross_attn"].items()
            if k in ("wq", "wk", "wv", "wo")}


def _cross_kv(lp, enc_out, cdt):
    return attention.kv_project(_cross(lp), enc_out, cdt)


def _dec_block(lp, h, enc_out, cfg, cdt, positions, *, self_cache=None,
               cross_kv=None, pos=None):
    """Causal self-attention (writing ``self_cache`` in place when given),
    cross-attention over the encoder output (or the given ``cross_kv``),
    then the MLP."""
    z = layers.rmsnorm(lp["ln1"], h, cfg.norm_eps)
    q, k, v = attention.qkv_project(lp["self_attn"], z, z, cfg, cdt)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if self_cache is None:
        ctx = _flash(q, k, v, cfg, causal=True)
    else:
        kc, vc = self_cache
        _write(kc, k, pos)
        _write(vc, v, pos)
        if q.shape[1] == 1:
            ctx = attention.decode_attention(q, kc, vc, pos + 1)
        else:
            ctx = _flash(q, k, v, cfg, causal=True)
    h = h + attention.attn_output(lp["self_attn"], ctx.to(cdt), cdt)

    # cross attention (not causal, encoder length fixed)
    z = layers.rmsnorm(lp["ln_x"], h, cfg.norm_eps)
    qx = attention.q_project(_cross(lp), z, cdt)
    kx, vx = _cross_kv(lp, enc_out, cdt) if cross_kv is None else cross_kv
    ctx = _flash(qx, kx, vx, cfg, causal=False)
    h = h + attention.attn_output(lp["cross_attn"], ctx.to(cdt), cdt)

    z = layers.rmsnorm(lp["ln2"], h, cfg.norm_eps)
    return h + layers.mlp(lp["mlp"], z, cdt)


def forward_features(params, batch, cfg: ModelConfig):
    cdt = _cdt(cfg)
    enc_out = encode(params, batch["src_embeds"], cfg)
    x = layers.embed(params["embed"], batch["tokens"], cdt)
    positions = _positions(x)
    sp = act_sharding.sequence_parallel(x.shape)

    def body(h, lp):
        h = unconstrain(h, sp)
        lp = gather_layer_params(lp)
        return constrain(_dec_block(lp, h, enc_out, cfg, cdt, positions))

    x = scan_layers_remat(body, constrain(x), unstack(params["decoder"],
                                                      cfg.n_layers), cfg)
    return layers.rmsnorm(params["final_norm"], unconstrain(x, sp),
                          cfg.norm_eps)


def head(params, x, cfg: ModelConfig, vocab_block: bool = False):
    return layers.lm_head(params["lm_head"], x, vocab_block)


def forward(params, batch, cfg: ModelConfig):
    """Training: batch = {src_embeds (b, ss, d), tokens (b, st)} -> logits."""
    return head(params, forward_features(params, batch, cfg), cfg)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, enc_len: int,
               device=None) -> dict:
    """Self-attention caches ``k``/``v`` of ``max_len`` and cross K/V
    ``xk``/``xv`` of ``enc_len``, stacked over decoder layers."""
    cdt = _cdt(cfg)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    z = lambda s: torch.zeros((L, batch_size, s, kvh, hd), dtype=cdt,
                              device=device)
    return {"k": z(max_len), "v": z(max_len), "xk": z(enc_len),
            "xv": z(enc_len)}


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """Encode + decoder prompt pass.  Returns (last logits, caches)."""
    cdt = _cdt(cfg)
    enc_out = encode(params, batch["src_embeds"], cfg)
    x = layers.embed(params["embed"], batch["tokens"], cdt)
    caches = init_cache(cfg, x.shape[0], max_len, enc_out.shape[1],
                        device=x.device)
    positions = _positions(x)
    for li, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
        x = constrain(x)
        kx, vx = _cross_kv(lp, enc_out, cdt)
        caches["xk"][li] = kx.to(cdt)
        caches["xv"][li] = vx.to(cdt)
        x = _dec_block(lp, x, enc_out, cfg, cdt, positions,
                       self_cache=(caches["k"][li], caches["v"][li]),
                       cross_kv=(kx, vx), pos=0)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.lm_head(params["lm_head"], x[:, -1:]), caches


def decode_step(params, batch, caches, pos, cfg: ModelConfig):
    """One decoder token against the caches; ``caches`` is updated in
    place (its ``k``/``v`` at ``pos``) and returned."""
    cdt = _cdt(cfg)
    x = layers.embed(params["embed"], batch["tokens"], cdt)
    positions = torch.full(x.shape[:2], int(pos), dtype=torch.int32,
                           device=x.device)
    for li, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
        x = _dec_block(lp, x, None, cfg, cdt, positions,
                       self_cache=(caches["k"][li], caches["v"][li]),
                       cross_kv=(caches["xk"][li], caches["xv"][li]),
                       pos=pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return layers.lm_head(params["lm_head"], x), caches
