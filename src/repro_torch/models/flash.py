"""Flash attention with a memory-exact backward.

The reference (``repro.models.flash``) pairs the online-softmax forward
with a ``jax.custom_vjp``: autodiff through the block loop would save every
block's probability matrix, O(S^2) memory, so the backward saves only
``(q, k, v, out, lse)`` and recomputes each score block.  Here the same
pair is a ``torch.autograd.Function`` (:class:`_Flash`).  The arithmetic is
the reference's, block for block: queries and keys padded to chunk
multiples, padded keys masked by ``kv_valid``, the causal mask offset by
``q_offset``, float32 running max ``m``, sum ``l`` and accumulator
``acc``, ``NEG_INF`` masking (so a query row whose first blocks are all
masked accumulates them at weight 1 until a valid block rescales them
away, as in the reference, and its ``lse`` stays finite); the backward
accumulates dq per q-block and dk/dv per kv-block in float32.

A kv block that lies wholly after a causal q block (or wholly in the
padding) is skipped in both directions: every score in it is ``NEG_INF``,
so once an earlier block has set the running max it adds exactly 0 to
``l`` and ``acc`` (``alpha`` is exactly 1) and exactly 0 to every
gradient (``p`` is exactly 0).  Block 0 always holds a valid key.

All tensors are (b, s, h, hd); kv heads may be fewer than h (repeated
here, so autograd sums dk/dv over the repeated heads).  Layout inside:
(b, h, s, hd).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def _mask_for(qpos, kpos, kv_valid, causal):
    m = kv_valid[None, :]
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    return m[None, None]                      # (1, 1, cq, ckv)


def _positions(nq, cq, nkv, ckv, q_offset, skv_valid, dev):
    q_pos = (q_offset + torch.arange(nq * cq, device=dev)).reshape(nq, cq)
    kv_pos = torch.arange(nkv * ckv, device=dev).reshape(nkv, ckv)
    kv_ok = (torch.arange(nkv * ckv, device=dev) < skv_valid).reshape(nkv,
                                                                      ckv)
    return q_pos, kv_pos, kv_ok


def _live(i, j, causal, cq, ckv, q_offset, skv_valid):
    """Whether kv block j holds any key that q block i may see."""
    if j * ckv >= skv_valid:
        return False
    return not causal or j * ckv <= q_offset + (i + 1) * cq - 1


def _fwd_impl(q, k, v, causal, cq, ckv, q_offset, skv_valid):
    """(out, lse) of padded (b, h, s, hd) inputs whose lengths are chunk
    multiples."""
    b, h, sq, hd = q.shape
    nq, nkv = sq // cq, k.shape[2] // ckv
    scale = hd ** -0.5
    dev = q.device
    q_pos, kv_pos, kv_ok = _positions(nq, cq, nkv, ckv, q_offset, skv_valid,
                                      dev)
    outs, lses = [], []
    for i in range(nq):
        qi = q[:, :, i * cq:(i + 1) * cq].float()
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        for j in range(nkv):
            if not _live(i, j, causal, cq, ckv, q_offset, skv_valid):
                continue
            kj = k[:, :, j * ckv:(j + 1) * ckv]
            vj = v[:, :, j * ckv:(j + 1) * ckv]
            s = (qi @ kj.float().transpose(-1, -2)) * scale
            s = torch.where(_mask_for(q_pos[i], kv_pos[j], kv_ok[j], causal),
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(vj.dtype).float() @ vj.float()
            m = m_new
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def _bwd_impl(q, k, v, out, lse, dout, causal, cq, ckv, q_offset,
              skv_valid):
    """(dq, dk, dv) in the inputs' dtypes: the reference's ``_flash_bwd``,
    each score block recomputed, ``p = exp(s - lse)``, ``delta =
    sum(dout * out)``, ``ds = p * (dp - delta) * scale``."""
    b, h, sq, hd = q.shape
    skv = k.shape[2]
    nq, nkv = sq // cq, skv // ckv
    scale = hd ** -0.5
    dev = q.device
    q_pos, kv_pos, kv_ok = _positions(nq, cq, nkv, ckv, q_offset, skv_valid,
                                      dev)
    do = dout.float()
    delta = (do * out.float()).sum(-1)                      # (b, h, sq)
    dk = torch.zeros((b, h, skv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, skv, hd), dtype=torch.float32, device=dev)
    dqs = []
    for i in range(nq):
        rows = slice(i * cq, (i + 1) * cq)
        qi, doi = q[:, :, rows].float(), do[:, :, rows]
        lsei, di = lse[:, :, rows], delta[:, :, rows]
        dq = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        for j in range(nkv):
            if not _live(i, j, causal, cq, ckv, q_offset, skv_valid):
                continue
            cols = slice(j * ckv, (j + 1) * ckv)
            kj, vj = k[:, :, cols].float(), v[:, :, cols].float()
            s = (qi @ kj.transpose(-1, -2)) * scale
            s = torch.where(_mask_for(q_pos[i], kv_pos[j], kv_ok[j], causal),
                            s, NEG_INF)
            p = torch.exp(s - lsei[..., None])             # (b, h, cq, ckv)
            dv[:, :, cols] += p.transpose(-1, -2) @ doi
            dp = doi @ vj.transpose(-1, -2)
            ds = p * (dp - di[..., None]) * scale
            dq = dq + ds @ kj
            dk[:, :, cols] += ds.transpose(-1, -2) @ qi
        dqs.append(dq)
    dq = torch.cat(dqs, dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Padded (b, h, s, hd) attention whose backward recomputes the score
    blocks from the saved ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, cq, ckv, q_offset, skv_valid):
        out, lse = _fwd_impl(q, k, v, causal, cq, ckv, q_offset, skv_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, cq, ckv, q_offset, skv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _attend(q, k, v, causal, chunk_q, chunk_kv, q_offset, core):
    """Repeat kv heads, pad to chunk multiples, run ``core`` on the
    (b, h, s, hd) layout and cut the padding off again."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if k.shape[2] != h:
        rep = h // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    cq = min(chunk_q, sq)
    ckv = min(chunk_kv, skv)
    nq, nkv = -(-sq // cq), -(-skv // ckv)
    pq, pkv = nq * cq - sq, nkv * ckv - skv
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if pq:
        qt = F.pad(qt, (0, 0, 0, pq))
    if pkv:
        kt = F.pad(kt, (0, 0, 0, pkv))
        vt = F.pad(vt, (0, 0, 0, pkv))
    out = core(qt, kt, vt, causal, cq, ckv, q_offset, skv)
    return out.transpose(1, 2)[:, :sq]


def flash_attention(q, k, v, *, causal: bool, chunk_q: int, chunk_kv: int,
                    q_offset: int = 0):
    """Public API, (b, s, h, hd) layout, kv heads may be < h (repeated
    here).  Pads s to chunk multiples; invalid kv masked out."""
    return _attend(q, k, v, causal, chunk_q, chunk_kv, q_offset, _Flash.apply)


def flash_attention_naive_grad(q, k, v, *, causal: bool, chunk_q: int,
                               chunk_kv: int, q_offset: int = 0):
    """The same forward with autograd through the block loop, which saves
    every score block (the reference's ``chunked_attention_naive_grad``):
    the oracle the memory-exact backward is held to."""
    return _attend(q, k, v, causal, chunk_q, chunk_kv, q_offset,
                   lambda *a: _fwd_impl(*a)[0])
