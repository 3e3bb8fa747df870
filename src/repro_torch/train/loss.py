"""Training losses: token cross entropy with z-loss, whole or in chunks.

The port of ``repro.train.loss``.  Both return ``(loss, metrics)`` with
``loss``, argmax ``accuracy`` and ``perplexity`` = exp(min(loss, 20)),
all float32 over the masked tokens.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import checkpoint


def _nll(logits, labels, z_loss):
    """Per-token negative log-likelihood (+ z-loss) of float32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll


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


def chunked_cross_entropy(head_fn, features, labels, *, chunk: int = 512,
                          z_loss: float = 1e-4, mask=None):
    """CE over sequence chunks so the (b, s, vocab) logits never
    materialise.

    ``head_fn(x_chunk) -> logits_chunk``; each chunk's body is
    checkpointed when a backward may follow, so the backward recomputes
    its logits instead of storing them -- peak memory is one
    (b, chunk, vocab) float32 block.
    """
    b, s, _ = features.shape
    c = min(chunk, s)
    assert s % c == 0, (s, c)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32,
                          device=features.device)

    def body(f, lab, m):
        logits = head_fn(f).float()
        m = m.float()
        nll = (_nll(logits, lab, z_loss) * m).sum()
        hits = ((torch.argmax(logits, -1) == lab) * m).sum()
        return nll, hits, m.sum()

    run = checkpoint if torch.is_grad_enabled() else (lambda f, *a: f(*a))
    nll_sum = acc_sum = cnt = torch.zeros((), dtype=torch.float32,
                                          device=features.device)
    for i in range(0, s, c):
        n, a, k = run(body, features[:, i:i + c], labels[:, i:i + c],
                      mask[:, i:i + c])
        nll_sum, acc_sum, cnt = nll_sum + n, acc_sum + a, cnt + k
    denom = torch.clamp(cnt, min=1.0)
    return _metrics(nll_sum / denom, acc_sum / denom)
