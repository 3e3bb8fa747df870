"""Architecture registry: arch-id config -> model functions, input shapes.

``input_specs`` gives a dry-run cell's inputs as meta tensors (shapes and
dtypes, nothing allocated), where the reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import act_sharding
from repro_torch.tree import flatten


@dataclasses.dataclass(frozen=True)
class Arch:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    forward_features: Callable
    head: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def make_arch(cfg: ModelConfig) -> Arch:
    """The model functions of ``cfg``.  ``init(gen, device=None)`` draws
    the params on ``gen``'s device (``device="meta"``: shapes and dtypes
    only); ``init_cache(bsz, max_len, enc_len=None, device=None)``
    allocates (``enc_len``: the encoder-decoder's cross K/V length,
    ``max_len`` when not given; the other families ignore it).  Outside
    ``act_sharding.zero3`` the functions that take params raise for a
    leaf that is not its whole shape (a mesh's block)."""
    if cfg.family == "encdec":
        m = encdec
        init_cache = lambda bsz, max_len, enc_len=None, device=None: \
            encdec.init_cache(cfg, bsz, max_len, enc_len or max_len,
                              device=device)
    else:
        m = transformer
        init_cache = lambda bsz, max_len, enc_len=None, device=None: \
            transformer.init_cache(cfg, bsz, max_len, device=device)
    shapes = {}

    def whole(p):
        if not act_sharding.sharded():
            if not shapes:
                keys, leaves = flatten(m.init_params(
                    torch.Generator(), cfg, device="meta"))
                shapes.update((k, tuple(x.shape))
                              for k, x in zip(keys, leaves))
            act_sharding.check_whole(p, shapes)
        return p

    return Arch(
        cfg=cfg,
        init=lambda gen, device=None: m.init_params(gen, cfg, device=device),
        forward=lambda p, b: m.forward(whole(p), b, cfg),
        forward_features=lambda p, b: m.forward_features(whole(p), b, cfg),
        head=lambda p, x, vocab_block=False: m.head(whole(p), x, cfg,
                                                    vocab_block),
        prefill=lambda p, b, max_len: m.prefill(whole(p), b, cfg, max_len),
        decode_step=lambda p, b, c, pos: m.decode_step(whole(p), b, c, pos,
                                                       cfg),
        init_cache=init_cache,
    )


# ---------------------------------------------------------------------------
# assigned input shapes (seq_len, global_batch) and applicability rules
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing; every assigned arch
    has a decoder."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention at 524288 tokens; "
                       "arch has no sub-quadratic variant -- skipped "
                       "per assignment rules")
    return True, ""


def input_specs(cfg: ModelConfig, shape_name: str, dtype=torch.int32):
    """Meta-tensor stand-ins for every model input of a dry-run cell.

    Returns (batch, extra) where extra carries the cache (meta tensors)
    for decode kinds.  No memory is allocated.
    """
    sh = SHAPES[shape_name]
    S, B = sh["seq_len"], sh["global_batch"]
    f = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    emb_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def token_batch(seq):
        if cfg.family == "vlm":
            return {"embeds": f((B, seq, cfg.d_model), emb_dt),
                    "positions": f((3, B, seq), torch.int32)}
        if cfg.family == "encdec":
            return {"src_embeds": f((B, seq, cfg.d_model), emb_dt),
                    "tokens": f((B, seq), torch.int32)}
        return {"tokens": f((B, seq), torch.int32)}

    if sh["kind"] == "train":
        batch = token_batch(S)
        batch["labels"] = f((B, S), torch.int32)
        return batch, None
    if sh["kind"] == "prefill":
        return token_batch(S), None
    # decode: one new token against a full cache of length S
    if cfg.family == "vlm":
        batch = {"embeds": f((B, 1, cfg.d_model), emb_dt),
                 "positions": f((3, B, 1), torch.int32)}
    else:
        batch = {"tokens": f((B, 1), torch.int32)}
    arch = make_arch(cfg)
    return batch, arch.init_cache(B, S, S, device="meta")
