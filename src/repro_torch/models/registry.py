"""Architecture registry: arch-id config -> model functions, input shapes.

``input_specs`` (the reference's ``eval_shape`` cache specs) comes with the
LM half of ``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig


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
    ``max_len`` when not given; the other families ignore it)."""
    if cfg.family == "encdec":
        m = encdec
        init_cache = lambda bsz, max_len, enc_len=None, device=None: \
            encdec.init_cache(cfg, bsz, max_len, enc_len or max_len,
                              device=device)
    else:
        m = transformer
        init_cache = lambda bsz, max_len, enc_len=None, device=None: \
            transformer.init_cache(cfg, bsz, max_len, device=device)
    return Arch(
        cfg=cfg,
        init=lambda gen, device=None: m.init_params(gen, cfg, device=device),
        forward=lambda p, b: m.forward(p, b, cfg),
        forward_features=lambda p, b: m.forward_features(p, b, cfg),
        head=lambda p, x: m.head(p, x, cfg),
        prefill=lambda p, b, max_len: m.prefill(p, b, cfg, max_len),
        decode_step=lambda p, b, c, pos: m.decode_step(p, b, c, pos, cfg),
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
