"""Segment reductions: per-UE rows into per-cell bins.

``segment_sum`` is ``index_add_`` and ``segment_max`` is
``scatter_reduce("amax", include_self=True)`` over a ``fill``-initialised
output.  On CUDA both use atomics in no fixed order, so a float
``segment_sum`` matches the JAX scatter-add only to rounding, never
bitwise; integer sums and maxima are exact.
"""
from __future__ import annotations

import torch


def segment_sum(data, seg, n_seg: int):
    """``out[j] = sum_{i: seg[i] == j} data[i]`` over ``data``'s axis 0."""
    out = torch.zeros((int(n_seg),) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg.long(), data)


def segment_max(data, seg, n_seg: int, fill=float("-inf")):
    """``out[j] = max(fill, max_{i: seg[i] == j} data[i])`` over axis 0."""
    out = torch.full((int(n_seg),) + tuple(data.shape[1:]), float(fill),
                     dtype=data.dtype, device=data.device)
    idx = seg.long().reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce="amax", include_self=True)
