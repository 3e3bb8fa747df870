"""Megatron-style tensor parallelism on the ``model`` axis: the
differentiable collectives.

In the reference GSPMD partitions each layer's compute by the weights'
layout (``parallel.sharding``): every device computes on its heads, FFN
columns, vocab rows and experts, and XLA inserts the collectives.  Here the
model code computes on the rank's blocks and calls these functions where
the collectives go.  The tokens are replicated along ``model`` (the batch
sits on the batch axes), so each tensor of the forward pass is one of

* replicated -- the same values on every rank of ``model``; its gradient
  is held whole on every rank;
* local -- the rank's part (its heads, columns, experts, sequence block);
* partial -- one rank's term of a sum over ``model``.

Three functions move between them, each the transpose of another in the
backward:

* :func:`psum` -- partial to replicated; the backward is the identity;
* :func:`copy` -- the identity on a replicated tensor about to feed local
  compute; the backward sums the local gradients;
* :func:`assemble` -- local blocks along one dimension to the replicated
  whole; the backward keeps the rank's block of the gradient, with no sum
  (every rank holds the whole gradient of a replicated tensor).

:func:`split` (replicated to the rank's block) is :func:`copy` then a
slice.  Gloo on CUDA tensors has only ``all_reduce`` and ``broadcast``, so
every call is an all-reduce of ``core.distributed`` (counted by its
``collective_stats``): an assemble is the psum of a zero-filled buffer
holding the rank's block (exact).  ``ax`` is the ``model`` axis
(``Mesh.axes("model")``); ``None`` or an axis of one rank makes no call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distributed as D


def active(ax) -> bool:
    """Whether ``ax`` spans more than one rank."""
    return ax is not None and ax.size > 1


def _assemble(x, ax, dim):
    dim %= x.dim()
    shape = list(x.shape)
    loc = shape[dim]
    shape[dim] = loc * ax.size
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, ax.index * loc, loc).copy_(x)
    return D.psum(buf, ax)


def _block(x, ax, dim):
    dim %= x.dim()
    loc = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * loc, loc).contiguous()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return D.psum(x.contiguous(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.psum(g.contiguous(), ctx.ax), None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _assemble(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.ax, ctx.dim), None, None


def psum(x, ax):
    """The sum over ``model`` of a partial tensor (backward: identity)."""
    return _Psum.apply(x, ax) if active(ax) else x


def copy(x, ax):
    """A replicated tensor entering local compute (backward: psum)."""
    return _Copy.apply(x, ax) if active(ax) else x


def assemble(x, ax, dim: int):
    """The replicated whole of the rank blocks ``x`` along ``dim``
    (backward: the rank's block of the gradient)."""
    return _Assemble.apply(x, ax, dim) if active(ax) else x


def split(x, ax, dim: int):
    """The rank's block along ``dim`` of a replicated tensor (backward:
    the blocks' gradients assembled)."""
    return _block(copy(x, ax), ax, dim) if active(ax) else x


def pmax(x, ax):
    """The maximum over ``model`` (not differentiated: of values without
    a gradient)."""
    return D.pmax(x.contiguous(), ax) if active(ax) else x


def pmin(x, ax):
    """The minimum over ``model`` (not differentiated)."""
    return D.pmin(x.contiguous(), ax) if active(ax) else x


class VocabBlock(NamedTuple):
    """The rank's vocab columns of float32 logits (..., V / model), the
    global index of its first column, and the ``model`` axis: what the
    head returns inside a sharded train step when the vocab is on
    ``model`` (``train.loss`` combines the ranks' columns exactly)."""

    logits: torch.Tensor
    offset: int
    ax: object


def offset(n_local: int, ax) -> int:
    """The global index of the first element of the rank's block of
    ``n_local`` elements (0 without ``ax``)."""
    return ax.index * n_local if active(ax) else 0
