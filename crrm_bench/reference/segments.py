"""Segment reductions: per-UE rows into per-cell bins.

``segment_sum`` is ``index_add_`` and ``segment_max`` is
``scatter_reduce("amax", include_self=True)`` over a ``fill``-initialised
output.  Autograd records both (the relaxed engine differentiates through
them): the in-place write lands on a fresh buffer, not on a leaf.  A
max's gradient splits evenly over the rows tied at a bin's maximum, where
JAX's scatter-max gradient may split otherwise; the relaxed engine uses
the maximum only as a stabiliser, whose gradient cancels.  On CUDA both
use atomics in no fixed order, so a float ``segment_sum`` matches the JAX
scatter-add only to rounding, never bitwise; integer sums and maxima are
exact.

A batch of envs passes ``(B, n, ...)`` data with ``(B, n)`` ids: the batch
coordinate folds into the ids, ``seg + n_seg * b``, and one flat reduction
fills ``B * n_seg`` bins (the reference's custom-vmap rule).  Within one
env the rows keep their order, so on the CPU, where ``index_add_`` adds
in index order, each env's bins equal the unbatched reduction bit for
bit.  Unbatched calls are the plain 1-D reductions.
"""
from __future__ import annotations

import torch


def _flat(data, seg, n_seg: int):
    """``(flat data, flat ids, bins, output shape)`` of one reduction."""
    n_seg = int(n_seg)
    if seg.dim() == 1:
        return data, seg.long(), n_seg, (n_seg,) + tuple(data.shape[1:])
    b, n = seg.shape
    off = n_seg * torch.arange(b, dtype=torch.int64, device=seg.device)
    ids = (seg.long() + off[:, None]).reshape(-1)
    rest = tuple(data.shape[2:])
    return data.reshape((b * n,) + rest), ids, b * n_seg, (b, n_seg) + rest


def segment_sum(data, seg, n_seg: int):
    """``out[..., j] = sum_{i: seg[..., i] == j} data[..., i]`` over the UE
    axis (axis 0, or axis 1 under a batch)."""
    flat, ids, bins, shape = _flat(data, seg, n_seg)
    out = torch.zeros((bins,) + tuple(flat.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, flat).reshape(shape)


def segment_max(data, seg, n_seg: int, fill=float("-inf")):
    """``out[..., j] = max(fill, max_{i: seg[..., i] == j} data[..., i])``."""
    flat, ids, bins, shape = _flat(data, seg, n_seg)
    out = torch.full((bins,) + tuple(flat.shape[1:]), float(fill),
                     dtype=data.dtype, device=data.device)
    idx = ids.reshape((-1,) + (1,) * (flat.dim() - 1)).expand_as(flat)
    return out.scatter_reduce_(0, idx, flat, reduce="amax",
                               include_self=True).reshape(shape)


def take(x, seg):
    """``x[..., seg[..., i], ...]``: each row's bin of a per-segment tensor
    (``x`` (n_seg, ...) with ``seg`` (n,), or (B, n_seg, ...) with (B, n))."""
    if seg.dim() == 1:
        return x[seg.long()]
    rows = torch.arange(seg.shape[0], device=seg.device)[:, None]
    return x[rows, seg.long()]
