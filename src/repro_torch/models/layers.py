"""Shared neural blocks: norms, rotary embeddings, projections, MLPs.

Parameters are plain nested dicts of tensors, in the reference's layout
(``repro.models.layers``).  Init functions take a ``torch.Generator`` and
build every leaf on its device; their draws are the port's own, so parity
with the reference goes through ``repro_torch.convert.lm_params``.  Every
init takes ``lead``, the shape of leading stack axes: the transformer draws
a whole stack of layers at once (``lead=(L,)``) instead of stacking L
draws.  Apply functions are pure and cast where the reference casts:
weights to the compute dtype at each use, RMSNorm, RoPE and logits in
float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import act_sharding, tp

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def on(gen: torch.Generator, device=None) -> torch.device:
    """Where an init builds its leaves: ``device``, else ``gen``'s.  On
    ``"meta"`` nothing is drawn or allocated: the tree's shapes and dtypes
    only (the reference's ``eval_shape``)."""
    return torch.device(device) if device is not None else gen.device


_SINKS: list = []


@contextlib.contextmanager
def leaf_sink(fn):
    """Inside the block every weight :func:`dense_init` and :func:`normal`
    draw is passed through ``fn`` as soon as it is drawn, and the init
    keeps what ``fn`` returns (the serving engine keeps the rank's block
    of each, so that no rank holds the whole tree)."""
    _SINKS.append(fn)
    try:
        yield
    finally:
        _SINKS.pop()


def _drawn(w):
    return _SINKS[-1](w) if _SINKS else w


def dense_init(gen: torch.Generator, shape, in_axis_size,
               dtype=torch.float32, lead=(), device=None):
    """Truncated-normal fan-in init (the MaxText/T5 default): N(0, 1)
    truncated at +-2, scaled by 1/sqrt(fan-in)."""
    std = 1.0 / math.sqrt(in_axis_size)
    w = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=on(gen, device))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return _drawn(w.mul_(std).to(dtype))


def normal(gen: torch.Generator, shape, scale, dtype=torch.float32, lead=(),
           device=None):
    """``scale`` * N(0, 1) of ``lead + shape``."""
    w = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=on(gen, device))
    w.normal_(generator=gen)
    return _drawn(w.mul_(scale).to(dtype))


# -- RMSNorm ------------------------------------------------------------------
def rmsnorm_init(d, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params, x, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


# -- Rotary position embeddings ---------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x, angles):
    """x (b, s, h, hd) rotated by ``angles`` (b, s, hd/2), in float32."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (b, s, h, hd); positions: (b, s) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE.

    positions3: (3, b, s) -- temporal / height / width position ids.
    ``sections`` (e.g. (16, 24, 24), summing to head_dim/2) assigns rotary
    frequency channels to the three components.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to "
                         f"head_dim/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    # per-frequency-channel component selector: 0=t, 1=h, 2=w
    sel = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])        # (hd/2,)
    pos = positions3[sel]                                     # (hd/2, b, s)
    pos = torch.movedim(pos, 0, -1).float()                   # (b, s, hd/2)
    return _rotate(x, pos * freqs)


# -- dense MLP (SwiGLU) ---------------------------------------------------------
def mlp_init(gen, d_model, d_ff, dtype=torch.float32, lead=(), device=None):
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff), d_model, dtype, lead,
                              device),
        "wi_up": dense_init(gen, (d_model, d_ff), d_model, dtype, lead,
                            device),
        "wo": dense_init(gen, (d_ff, d_model), d_ff, dtype, lead, device),
    }


def mlp(params, x, compute_dtype):
    """SwiGLU.  Under tensor parallelism with ``wi_gate``/``wi_up``
    column blocks (F on ``model``), ``wo`` is row-parallel and the output
    one psum."""
    ax = act_sharding.tp_axis(params["wi_gate"], 1)
    return tp.psum(mlp_partial(params, tp.copy(x, ax), compute_dtype), ax)


def mlp_partial(params, x, compute_dtype):
    """The SwiGLU of ``x`` on the rank's F columns: its term of the sum
    over ``model`` (the whole output when the weights are whole)."""
    h = F.silu(x @ params["wi_gate"].to(compute_dtype))
    h = h * (x @ params["wi_up"].to(compute_dtype))
    return h @ params["wo"].to(compute_dtype)


# -- embeddings --------------------------------------------------------------------
def embed_init(gen, vocab, d_model, dtype=torch.float32, device=None):
    return {"embedding": normal(gen, (vocab, d_model), 0.02, dtype,
                                device=device)}


def embed(params, tokens, compute_dtype):
    """Rows of the table for ``tokens``.  With vocab rows on ``model``
    the lookup is vocab-parallel: the rank's rows, zeros for the others'
    tokens, one psum; with D on ``model`` the columns are assembled."""
    table = params["embedding"]
    dim = act_sharding.tp_dim(table)
    ax = act_sharding.model_axis()
    if dim == 0:
        local = tokens.long() - tp.offset(table.shape[0], ax)
        mine = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(mine, local, 0)]
        rows = torch.where(mine[..., None], rows, 0.0)
        return tp.psum(rows.to(compute_dtype), ax)
    # gather then cast: the same values as the reference's cast-then-gather,
    # without converting the whole table on every call
    rows = table[tokens.long()].to(compute_dtype)
    return tp.assemble(rows, ax, -1) if dim == 1 else rows


def _vocab_logits(x, w_t, ax, vocab_block=False):
    """float32 ``x @ w_t`` with the vocab on ``model`` when ``ax`` is that
    axis: the rank's columns from a replicated ``x``, assembled -- or,
    with ``vocab_block``, returned as a ``tp.VocabBlock`` (the loss
    combines the ranks' columns without assembling them)."""
    local = tp.copy(x.float(), ax) @ w_t.float()
    if vocab_block and tp.active(ax):
        return tp.VocabBlock(local, tp.offset(local.shape[-1], ax), ax)
    return tp.assemble(local, ax, -1)


def unembed(params, x, vocab_block=False):
    """Logits in float32 for a stable softmax/loss (``vocab_block``: see
    :func:`_vocab_logits`)."""
    table = params["embedding"]
    dim = act_sharding.tp_dim(table)
    if dim == 1:                  # D on 'model': assemble the table
        table = tp.assemble(table, act_sharding.model_axis(), 1)
    return _vocab_logits(x, table.T, act_sharding.model_axis()
                         if dim == 0 else None, vocab_block)


def lm_head_init(gen, d_model, vocab, dtype=torch.float32, device=None):
    return {"kernel": dense_init(gen, (d_model, vocab), d_model, dtype,
                                 device=device)}


def lm_head(params, x, vocab_block=False):
    """Logits in float32; with the vocab columns on ``model`` the rank's
    columns, assembled for the sampler (with ``vocab_block``, for the
    loss, left as the rank's :class:`~repro_torch.parallel.tp.VocabBlock`)."""
    kernel = params["kernel"]
    return _vocab_logits(x, kernel, act_sharding.tp_axis(kernel, 1),
                         vocab_block)
