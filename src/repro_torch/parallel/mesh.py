"""Mesh construction + axis conventions.

The port of ``repro.parallel.mesh``.  Logical axis convention
(MaxText-flavoured):
  * ``batch``  -> all non-model mesh axes (("pod", "data") on the multi-pod
                  mesh, ("data",) on one pod) -- DP.
  * ``model``  -> tensor/expert parallel axis -- TP/EP.
  * sequence-sharding (SP) reuses the batch axes for batch-1 long-context.

Two kinds of mesh carry these axes.  :func:`make_host_mesh` lays the ranks
of the initialised default process group out as a
``core.distributed.Mesh`` (the ranks run the sharded train step).  The
production meshes (pod 16x16, multi-pod 2x16x16) do not fit one host, so
:func:`make_production_mesh` returns a :class:`ShapeMesh`: the axis names
and sizes and nothing else.  The sharding rules read only ``mesh.shape``
and ``mesh.axis_names``, so they take either kind, and the dry-run reckons
per-device bytes over a shape-only mesh.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.distributed import make_mesh


class ShapeMesh:
    """A mesh as the sharding rules see it: ``axis_names`` and ``shape``
    (axis name -> size), with no ranks and no process groups."""

    def __init__(self, shape, axis_names):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             f"must pair up one to one")
        self.axis_names = names
        self.shape = dict(zip(names, shape))

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def mesh_size(mesh) -> int:
    """The number of devices (ranks) of either kind of mesh."""
    return math.prod(mesh.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The assignment's production mesh: 16x16 per pod, 2 pods multi-pod
    (shape only: one host cannot hold it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ShapeMesh(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh over the ranks of the initialised default
    group (``device=None``: the card).  When ``data * model`` exceeds the
    world size it falls back to ``(world, 1)``, as the reference falls back
    on its device count; a mesh must cover every rank of the group."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group)")
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return make_mesh((data, model), ("data", "model"), device)


_STRATEGY = {"mode": "2d"}


def set_strategy(mode: str) -> None:
    """Parallelism strategy: '2d' = DP(+FSDP) x TP (default);
    'dp' = ZeRO-3 data parallelism over ALL mesh axes (no tensor
    parallelism).  Process-global, as the reference's."""
    if mode not in ("2d", "dp"):
        raise ValueError(f"strategy {mode!r}: '2d' or 'dp'")
    _STRATEGY["mode"] = mode


def get_strategy() -> str:
    return _STRATEGY["mode"]


def batch_axes(mesh) -> tuple:
    """All mesh axes that carry the batch."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    if _STRATEGY["mode"] == "dp":
        axes = axes + ("model",)
    return axes


def tp_size(mesh) -> int:
    """Tensor-parallel degree under the active strategy."""
    return 1 if _STRATEGY["mode"] == "dp" else mesh.shape["model"]


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
