"""Training losses: token cross entropy with z-loss, whole or in chunks.

The port of ``repro.train.loss``.  Both return ``(loss, metrics)`` with
``loss``, argmax ``accuracy`` and ``perplexity`` = exp(min(loss, 20)),
all float32 over the masked tokens.

:func:`chunked_ce_sums` is also vocab-parallel: when the head returns the
rank's vocab columns (``parallel.tp.VocabBlock``, inside a sharded train
step with the vocab on ``model``) each chunk combines the ranks' columns
exactly, with no (b, s, V) assembly: a pmax of the row max (no gradient),
one psum of the exp-sum and of the gold logit (which the rank owning the
label supplies, the others 0), all in float32, with the backward of
``torch.logsumexp`` as in the unsharded path; for the accuracy the
global argmax with ties to the lowest index, as ``torch.argmax`` takes
it on the whole row (a pmin of the winning global index among the ranks
at the max).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import checkpoint
from repro_torch.parallel import tp


def _nll(logits, labels, z_loss):
    """Per-token negative log-likelihood (+ z-loss) of float32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll


class _VocabLse(torch.autograd.Function):
    """``(lse, gold)`` per token of the ranks' vocab columns: one psum of
    the exp-sum and of the gold logit; the backward is
    ``torch.logsumexp``'s, ``g * exp(x - lse)``, on the rank's columns,
    plus the gold logit's gradient where the rank owns the label."""

    @staticmethod
    def forward(ctx, logits, row_max, local, mine, ax):
        at = torch.where(mine, local, 0)[..., None]
        gold = torch.gather(logits, -1, at)[..., 0]
        sums = tp.psum(torch.stack([
            torch.exp(logits - row_max[..., None]).sum(-1),
            torch.where(mine, gold, 0.0)]), ax)
        lse = row_max + torch.log(sums[0])
        ctx.save_for_backward(logits, lse, at, mine)
        return lse, sums[1]

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, lse, at, mine = ctx.saved_tensors
        g = g_lse[..., None] * torch.exp(logits - lse[..., None])
        g = g.scatter_add(-1, at, torch.where(mine, g_gold, 0.0)[..., None])
        return g, None, None, None, None


def _vocab_parallel(blk, labels, z_loss):
    """``(nll, argmax)`` per token of the ranks' vocab columns
    (``tp.VocabBlock``): the same as :func:`_nll` and ``torch.argmax`` on
    the whole row, with the exp-sum added up over the ranks."""
    logits, ax = blk.logits.float(), blk.ax
    v_loc = torch.amax(logits.detach(), dim=-1)
    i_loc = torch.argmax(logits.detach(), dim=-1) + blk.offset
    row_max = tp.pmax(v_loc, ax)
    local = labels.long() - blk.offset
    mine = (local >= 0) & (local < logits.shape[-1])
    lse, gold = _VocabLse.apply(logits, row_max, local, mine, ax)
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    top = torch.where(v_loc == row_max, i_loc,
                      torch.iinfo(i_loc.dtype).max)
    return nll, tp.pmin(top, ax)


def _metrics(loss, acc):
    return loss, {"loss": loss, "accuracy": acc,
                  "perplexity": torch.exp(torch.clamp(loss, max=20.0))}


def cross_entropy(logits, labels, *, z_loss: float = 1e-4, mask=None):
    """Token-level CE in f32 with an optional z-loss regulariser.

    logits: (b, s, V); labels: (b, s) int.  Returns (loss, metrics).
    """
    logits = logits.float()
    nll = _nll(logits, labels, z_loss)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((torch.argmax(logits, -1) == labels) * mask).sum() / denom
    return _metrics(loss, acc)


def chunked_ce_sums(head_fn, features, labels, *, chunk: int = 512,
                    z_loss: float = 1e-4, mask=None):
    """``(nll_sum, hits, count)`` of the masked tokens in float32, over
    sequence chunks so the (b, s, vocab) logits never materialise.

    ``head_fn(x_chunk) -> logits_chunk`` (or the rank's
    ``tp.VocabBlock`` of them: vocab-parallel, see the module docstring);
    each chunk's body is checkpointed when a backward may follow, so the
    backward recomputes its logits instead of storing them -- peak memory
    is one (b, chunk, vocab) float32 block (of the rank's vocab columns).
    The sums of a sharded batch add up over its blocks (``train.step``'s
    sharded loss).
    """
    b, s, _ = features.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32,
                          device=features.device)

    def body(f, lab, m):
        out = head_fn(f)
        m = m.float()
        if isinstance(out, tp.VocabBlock):
            nll, top = _vocab_parallel(out, lab, z_loss)
        else:
            logits = out.float()
            nll, top = _nll(logits, lab, z_loss), torch.argmax(logits, -1)
        return (nll * m).sum(), ((top == lab) * m).sum(), m.sum()

    run = checkpoint if torch.is_grad_enabled() else (lambda f, *a: f(*a))
    nll_sum = acc_sum = cnt = torch.zeros((), dtype=torch.float32,
                                          device=features.device)
    for i in range(0, s, c):
        n, a, k = run(body, features[:, i:i + c], labels[:, i:i + c],
                      mask[:, i:i + c])
        nll_sum, acc_sum, cnt = nll_sum + n, acc_sum + a, cnt + k
    return nll_sum, acc_sum, cnt


def chunked_cross_entropy(head_fn, features, labels, *, chunk: int = 512,
                          z_loss: float = 1e-4, mask=None):
    """CE over sequence chunks (:func:`chunked_ce_sums`); returns
    ``(loss, metrics)``."""
    return metrics_of_sums(*chunked_ce_sums(head_fn, features, labels,
                                            chunk=chunk, z_loss=z_loss,
                                            mask=mask))


def metrics_of_sums(nll_sum, acc_sum, cnt):
    """``(loss, metrics)`` of summed CE numerators and a token count."""
    denom = torch.clamp(cnt, min=1.0)
    return _metrics(nll_sum / denom, acc_sum / denom)
