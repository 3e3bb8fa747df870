"""ZeRO-3 over ``torch.distributed``: blocks, gathers, and the optimizer's
whole-leaf reductions.

The reference shards every param, gradient and optimizer moment by its
``sharding`` spec and lets GSPMD insert the collectives.  In eager PyTorch
they are explicit, and all of them are all-reduces of
``core.distributed`` (counted by ``collective_stats``; gloo on CUDA
tensors has only ``all_reduce`` and ``broadcast``): a gather is the psum of
a zero-filled global buffer holding the rank's block (:func:`assemble`,
exact), a reduce-scatter is a psum followed by the rank's block.

* :func:`gather` -- a leaf's block to the full leaf, differentiable: the
  backward sums the full gradient over the axes whose ranks hold distinct
  data (``grad_axes``) and keeps the rank's block.  With ``cast`` the
  leaf is gathered in that dtype and comes back in its own dtype holding
  the cast's values; the backward then rounds the *summed* gradient to
  ``cast`` -- the reference's order: its astype's transpose follows the
  reduction of the gradient over the batch.
* :class:`Layout` / :class:`Shards` -- each leaf's spec, full shape and
  mesh, for the optimizer's reductions over a whole leaf (the global
  norm, Adafactor's row and column means and update RMS).
* :func:`block` / :func:`assemble` with ``key`` -- a global leaf to this
  rank's block and back, the one place that does so for the params and
  the train state (the serving engine's draw and ``load_params``,
  ``train.step.block_tree`` / ``unblock_tree``, the checkpoint's restore
  by shardings).  A leaf's block is its contiguous block under its spec,
  except where the rules interleave a leaf's x and z columns
  (``sharding.xz_ranks``: a Mamba ``in_proj`` computing tensor-parallel on
  ``model``): rank r's block is then x block r followed by z block r.
  The spec stays the reference's, and the assembled leaf is the
  reference's global leaf.

A group of one rank makes no call at all.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distributed import PartitionSpec, psum
from repro_torch.parallel import sharding as shd
from repro_torch.tree import flatten


def spec_axes(spec) -> tuple:
    """Every axis name ``spec`` shards over, in order."""
    out = []
    for axes in spec:
        if axes is None:
            continue
        out += [axes] if isinstance(axes, str) else list(axes)
    return tuple(out)


def padded(spec, ndim: int) -> PartitionSpec:
    """``spec`` with one entry per dimension."""
    return PartitionSpec(*(tuple(spec) + (None,) * (ndim - len(spec))))


def psum_over(x, mesh, axes):
    """psum of ``x`` over ``axes`` of ``mesh``; no call when they hold one
    rank (or none)."""
    axes = tuple(dict.fromkeys(axes))
    if not axes or math.prod(mesh.shape[a] for a in axes) == 1:
        return x
    return psum(x, mesh.axes(axes))


def _xz_block(x, m: int, r: int, key):
    """Rank ``r``'s columns of ``[x | z]`` over ``m`` ranks: x block r
    followed by z block r."""
    n = x.shape[-1]
    if n % (2 * m):
        raise ValueError(f"{key}: {n // 2} Mamba channels do not divide "
                         f"over model={m}")
    c = n // (2 * m)
    return torch.cat([x[..., r * c:(r + 1) * c],
                      x[..., n // 2 + r * c:n // 2 + (r + 1) * c]], -1)


def block(mesh, x, spec, key=None):
    """This rank's block of the global leaf ``x`` under ``spec``; with the
    leaf's ``key`` the block of a leaf whose x and z columns the rules
    interleave (``sharding.xz_ranks``) is its compute columns, cut
    without copying the whole leaf."""
    spec = padded(spec, x.dim())
    m = 1 if key is None else shd.xz_ranks(key, spec, mesh)
    if m == 1:
        return mesh.block(x, spec)
    x = _xz_block(x, m, mesh.axes("model").index, key)
    return mesh.block(x, PartitionSpec(*(tuple(spec[:-1]) + (None,))))


def assemble(mesh, x, spec, extra=(), key=None):
    """The global tensor whose block under ``spec`` is ``x``, summed also
    over the ``extra`` axes: ``x`` written into a zero-filled global
    buffer, one psum over every axis named.  Without such axes (or on one
    rank) ``x`` itself.  With the leaf's ``key`` interleaved blocks
    (:func:`block`) go back to the reference's columns."""
    spec = padded(spec, x.dim())
    m = 1 if key is None else shd.xz_ranks(key, spec, mesh)
    if m > 1:
        full = assemble(mesh, x, spec, extra)
        lead, n = full.shape[:-1], full.shape[-1]
        return full.reshape(lead + (m, 2, n // (2 * m))).transpose(
            -3, -2).reshape(lead + (n,))
    names = tuple(dict.fromkeys(spec_axes(spec) + tuple(extra)))
    if not names or math.prod(mesh.shape[a] for a in names) == 1:
        return x
    shape, index = list(x.shape), []
    for dim, axes in enumerate(spec):
        if axes is None:
            index.append(slice(None))
            continue
        ax = mesh.axes(axes)
        loc = x.shape[dim]
        shape[dim] = loc * ax.size
        index.append(slice(ax.index * loc, (ax.index + 1) * loc))
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf[tuple(index)] = x
    return psum(buf, mesh.axes(names))


def _full(block, mesh, spec, cast):
    """The full leaf of ``block``, rounded through ``cast`` when given."""
    full = assemble(mesh, block if cast is None else block.to(cast), spec)
    return full.to(block.dtype) if cast is not None else full.view_as(full)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, mesh, spec, grad_axes, cast):
        ctx.mesh, ctx.spec, ctx.grad_axes, ctx.cast = (mesh, spec,
                                                       grad_axes, cast)
        return _full(block, mesh, spec, cast)

    @staticmethod
    def backward(ctx, g):
        g = psum_over(g.contiguous(), ctx.mesh, ctx.grad_axes)
        if ctx.cast is not None:
            g = g.to(ctx.cast).to(g.dtype)
        return ctx.mesh.block(g, ctx.spec), None, None, None, None


def gather(block, mesh, spec, grad_axes=(), cast=None):
    """The full leaf of ``block`` (this rank's block under ``spec``),
    differentiable; see the module docstring.  Where no gradient flows
    (serving) the same values without the autograd node."""
    spec = padded(spec, block.dim())
    if torch.is_grad_enabled() and block.requires_grad:
        return _Gather.apply(block, mesh, spec, tuple(grad_axes), cast)
    return _full(block, mesh, spec, cast)


class Layout(NamedTuple):
    """One leaf of a sharded tree: its key path, spec, full shape and the
    mesh of its blocks."""

    mesh: object
    key: str
    spec: PartitionSpec
    shape: tuple

    def dim_axes(self, dim: int) -> tuple:
        axes = padded(self.spec, len(self.shape))[dim]
        return spec_axes((axes,))

    def full_sum(self, x, dim: int):
        """The sum over dimension ``dim`` of the full leaf whose block is
        ``x``, as a full (replicated) tensor."""
        dim %= len(self.shape)
        rest = padded(self.spec, len(self.shape))
        rest = PartitionSpec(*(rest[:dim] + rest[dim + 1:]))
        return assemble(self.mesh, x.sum(dim), rest, self.dim_axes(dim))

    def total(self, x):
        """The sum of every element of the full leaf whose block is
        ``x``."""
        return psum_over(x.sum(), self.mesh, spec_axes(self.spec))

    def replicas(self) -> int:
        """How many ranks hold each block (the axes the spec leaves
        out)."""
        return math.prod(self.mesh.shape.values()) // shd.shard_divisor(
            self.spec, self.mesh)

    def state_spec(self, path: str, shape) -> PartitionSpec:
        """The rules' spec of an optimizer-state leaf at ``path``."""
        return shd._param_rule(path, tuple(shape), self.mesh)


class Shards(NamedTuple):
    """The layouts of a sharded params tree, in ``tree.flatten``'s order:
    what ``train.optim``'s updates take as ``shards=``."""

    mesh: object
    layouts: list

    def norm_sq(self, leaves):
        """The sum of squares of every full leaf, in float32: each block's
        sum over the count of its replicas, summed over every rank."""
        total = 0
        for x, lay in zip(leaves, self.layouts):
            total = total + torch.sum(torch.square(x.to(torch.float32))) \
                / lay.replicas()
        return psum_over(total, self.mesh, self.mesh.axis_names)

    @classmethod
    def of(cls, mesh, params_shape, spec_tree):
        """The layouts of ``params_shape``'s leaves under ``spec_tree``."""
        keys, leaves = flatten(params_shape)
        return cls(mesh, [Layout(mesh, k, s, tuple(x.shape)) for k, x, s in
                          zip(keys, leaves, shd.spec_leaves(spec_tree))])
