"""Flash attention, forward only: the online softmax over KV blocks.

The reference (``repro.models.flash``) pairs this forward with a
memory-exact custom-VJP backward; serving needs no backward, which comes
with the training slice.  The arithmetic is the reference's, block for
block: queries and keys padded to chunk multiples, padded keys masked by
``kv_valid``, the causal mask offset by ``q_offset``, float32 running
max ``m``, sum ``l`` and accumulator ``acc``, ``NEG_INF`` masking (so a
query row whose first blocks are all masked accumulates them at weight 1
until a valid block rescales them away, as in the reference).

All tensors are (b, s, h, hd); kv heads may be fewer than h (repeated
here).  Layout inside: (b, h, s, hd).
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


def _fwd_impl(q, k, v, causal, cq, ckv, q_offset, skv_valid):
    """(out, lse) of padded (b, h, s, hd) inputs whose lengths are chunk
    multiples."""
    b, h, sq, hd = q.shape
    skv = k.shape[2]
    nq, nkv = sq // cq, skv // ckv
    scale = hd ** -0.5
    dev = q.device
    q_pos = (q_offset + torch.arange(nq * cq, device=dev)).reshape(nq, cq)
    kv_pos = torch.arange(nkv * ckv, device=dev).reshape(nkv, ckv)
    kv_ok = (torch.arange(nkv * ckv, device=dev) < skv_valid).reshape(nkv,
                                                                      ckv)
    outs, lses = [], []
    for i in range(nq):
        qi = q[:, :, i * cq:(i + 1) * cq].float()
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, hd), dtype=torch.float32, device=dev)
        for j in range(nkv):
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


def flash_attention(q, k, v, *, causal: bool, chunk_q: int, chunk_kv: int,
                    q_offset: int = 0):
    """Public API, (b, s, h, hd) layout, kv heads may be < h (repeated
    here).  Pads s to chunk multiples; invalid kv masked out."""
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
    out, _ = _fwd_impl(qt, kt, vt, causal, cq, ckv, q_offset, skv)
    return out.transpose(1, 2)[:, :sq]
