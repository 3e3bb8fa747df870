"""Distributed CRRM: the engine sharded over a mesh of ``torch.distributed``
ranks.

The port of ``repro.core.distributed``.  A :class:`Mesh` lays the ranks of
an already-initialised default process group out on named axes, row-major
as ``jax.make_mesh`` does, and holds one process group for every set of
axes; the collectives (:func:`psum`, :func:`pmax`, :func:`pmin`) are
``dist.all_reduce`` on the group of the named axes, and :func:`axis_index`
is the rank's linearised coordinate along them.  The caller initialises
the default group and so names the backend: nothing here picks one.

``shard_map``'s calling convention is kept: every rank is called with the
*global* inputs, takes its own block (:meth:`Mesh.block`, by a
:class:`PartitionSpec` per leaf) and returns *global* outputs, reassembled
by an all-reduce SUM of zero-filled global buffers (:meth:`Mesh.unblock`;
exact, since x + 0 = x, up to the sign of a zero).

Three step makers (UE rows sharded over the ``data`` axes, cells over
``model``), each returning ``f(U, C, Pw)`` or the incremental signature:

* :func:`make_materialized_step` -- every Figure-1 block materialised per
  shard; interference and attachment reduce over the cell axes.
* :func:`make_streaming_step` -- cell tiles streamed through an online
  (total, best) accumulator, so no UE x cell intermediate outlives a tile.
* :func:`make_incremental_rows_step` -- recompute only the moved UE rows
  against all cells and patch the O(N) state (w, u, a, best value).

:func:`_global_best` is the cross-shard argmax of the engine's UE x cell
mesh and of the max_cqi scheduler: the lowest global index wins a tie,
exactly ``torch.argmax`` on one device.

Every collective goes through one all-reduce, which counts its calls and
its bytes on the wire per device in a process-wide
:class:`CollectiveStats` (:func:`collective_stats`,
:func:`count_collectives`): the counterpart of the reference's
``analysis/hlo.py``, which reads them out of the compiled program.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import math
import threading
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.sim import phy


class PartitionSpec(tuple):
    """Which mesh axes each dimension of a tensor is sharded over: one
    entry per leading dimension, ``None`` (replicated), an axis name or a
    tuple of names (row-major over them); dimensions past the last entry
    are replicated.  ``PartitionSpec()`` is a replicated leaf."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A :class:`PartitionSpec` over a :class:`Mesh` (the target of
    ``train.checkpoint.restore(shardings=...)``)."""

    mesh: "Mesh"
    spec: PartitionSpec


def _names(axes) -> tuple:
    """An axis name or a sequence of names as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Axes(NamedTuple):
    """One or more axes of a mesh, bound to this rank: ``index`` is the
    rank's linearised coordinate along them (row-major), ``size`` their
    product and ``group`` the process group of the ranks that share every
    other coordinate with this one."""

    names: tuple
    index: int
    size: int
    group: object


class Mesh:
    """The ranks of the default process group on named axes.

    Rank ``r`` takes the row-major coordinate of ``r`` in ``shape``.  Every
    nonempty set of axes gets its process groups here, at construction,
    since ``dist.new_group`` is collective: each rank creates every group
    in the same order.  ``device`` is where this rank's tensors live.
    """

    def __init__(self, shape, axis_names, device):
        shape, names = tuple(int(s) for s in shape), _names(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             f"must pair up one to one")
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialised default "
                               "process group (torch.distributed."
                               "init_process_group)")
        world = dist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks; the default group "
                             f"has {world}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        coords = list(itertools.product(*(range(s) for s in shape)))
        self.coord = dict(zip(names, coords[self.rank]))
        self._groups = {}
        for n in range(1, len(names) + 1):
            for sub in itertools.combinations(names, n):
                if n == len(names):
                    self._groups[frozenset(sub)] = dist.group.WORLD
                    continue
                rest = [i for i, a in enumerate(names) if a not in sub]
                parts = {}
                for r, c in enumerate(coords):
                    parts.setdefault(tuple(c[i] for i in rest), []).append(r)
                mine = tuple(self.coord[names[i]] for i in rest)
                for key in sorted(parts):
                    g = dist.new_group(parts[key])
                    if key == mine:
                        self._groups[frozenset(sub)] = g

    def axes(self, axes) -> Axes:
        """The :class:`Axes` handle of one axis name or a tuple of them."""
        names = _names(axes)
        unknown = [a for a in names if a not in self.shape]
        if not names or unknown:
            raise ValueError(f"axes {names!r} are not axes of the mesh "
                             f"{self.axis_names}")
        index, size = 0, 1
        for a in names:
            index = index * self.shape[a] + self.coord[a]
            size *= self.shape[a]
        return Axes(names, index, size, self._groups[frozenset(names)])

    def block(self, x, spec):
        """This rank's block of the global tensor ``x`` under ``spec``."""
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            ax = self.axes(axes)
            n = x.shape[dim]
            if n % ax.size:
                raise ValueError(f"dimension {dim} of size {n} does not "
                                 f"divide over the {ax.size} shards of "
                                 f"{ax.names}")
            loc = n // ax.size
            x = x.narrow(dim, ax.index * loc, loc)
        return x.contiguous()

    def unblock(self, x, spec):
        """The global tensor whose block under ``spec`` is ``x`` on every
        rank: ``x`` written into a zero-filled global buffer, summed over
        the axes ``spec`` names.  A replicated leaf is returned as it is."""
        names = tuple(a for axes in spec if axes is not None
                      for a in _names(axes))
        if not names:
            return x
        shape, index = list(x.shape), []
        for dim, axes in enumerate(spec):
            if axes is None:
                index.append(slice(None))
                continue
            ax = self.axes(axes)
            loc = x.shape[dim]
            shape[dim] = loc * ax.size
            index.append(slice(ax.index * loc, (ax.index + 1) * loc))
        buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
        buf[tuple(index)] = x
        return psum(buf, self.axes(names))


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the initialised default group, the
    counterpart of ``jax.make_mesh``.  ``device=None`` means the card."""
    return Mesh(shape, axis_names, resolve_device(device))


@dataclasses.dataclass
class CollectiveStats:
    """Collectives by kind: ``counts`` (calls), ``bytes_by_kind`` and
    ``total_wire_bytes`` (bytes on the wire per device), the fields of the
    reference's ``analysis.hlo.CollectiveStats``.  The cost is the ring
    algorithm's, as ``hlo.py`` states it: an all-reduce of B bytes over n
    ranks puts 2 * B * (n - 1) / n on each device's wire, so a 1-rank
    group counts its calls and 0 bytes."""

    counts: dict = dataclasses.field(default_factory=dict)
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    total_wire_bytes: float = 0.0

    def add(self, kind: str, wire: float, calls: int = 1):
        self.counts[kind] = self.counts.get(kind, 0) + calls
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + wire
        self.total_wire_bytes += wire


#: every collective of this process since it started
_STATS = CollectiveStats()
_STATS_LOCK = threading.Lock()


def collective_stats() -> CollectiveStats:
    """A copy of this process's collective counts so far."""
    with _STATS_LOCK:
        return copy.deepcopy(_STATS)


@contextlib.contextmanager
def count_collectives():
    """Yields a :class:`CollectiveStats` that holds, once the block
    exits, the collectives this process made inside it."""
    before, region = collective_stats(), CollectiveStats()
    try:
        yield region
    finally:
        after = collective_stats()
        for kind, calls in after.counts.items():
            if calls > before.counts.get(kind, 0):
                region.add(kind, after.bytes_by_kind[kind]
                           - before.bytes_by_kind.get(kind, 0.0),
                           calls - before.counts.get(kind, 0))


def _all_reduce(x, ax: Axes, op):
    if x.dtype == torch.bool:
        raise TypeError("reduce a bool tensor as an integer one")
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y.reshape(-1) if y.dim() == 0 else y, op=op,
                    group=ax.group)
    wire = 2.0 * y.numel() * y.element_size() * (ax.size - 1) / ax.size
    with _STATS_LOCK:
        _STATS.add("all-reduce", wire)
    return y


def axis_index(ax: Axes) -> int:
    """This rank's linearised shard index over ``ax`` (row-major)."""
    return ax.index


def psum(x, ax: Axes):
    """The sum of ``x`` over the ranks of ``ax``: the same bits on each."""
    return _all_reduce(x, ax, dist.ReduceOp.SUM)


def pmax(x, ax: Axes):
    return _all_reduce(x, ax, dist.ReduceOp.MAX)


def pmin(x, ax: Axes):
    return _all_reduce(x, ax, dist.ReduceOp.MIN)


def check_replicated(tensors, mesh: Mesh, what: str):
    """Raise unless every tensor of ``tensors`` holds the same values on
    every rank of ``mesh`` (a pmax equal to the pmin): the replicated
    slots of a sharded state are computed per rank and only agree if every
    rank drew and counted alike."""
    world = mesh.axes(mesh.axis_names)
    for kind in (False, True):
        flat = [t.reshape(-1).to(torch.float64 if kind else torch.int64)
                for t in tensors
                if t is not None and t.is_floating_point() == kind]
        if not flat:
            continue
        v = torch.cat(flat)
        if not torch.equal(pmax(v, world), pmin(v, world)):
            raise RuntimeError(f"{what}: replicated values differ between "
                               f"the ranks of the mesh")


def _pad_cells(C_loc, P_loc, tile: int):
    """Pad the local cell block to a tile multiple with zero-power cells."""
    m_loc = C_loc.shape[0]
    pad = (-m_loc) % tile
    if pad:
        C_loc = torch.cat([C_loc, torch.full((pad, 3), 1e9, dtype=C_loc.dtype,
                                             device=C_loc.device)])
        P_loc = torch.cat([P_loc, torch.zeros((pad, P_loc.shape[1]),
                                              dtype=P_loc.dtype,
                                              device=P_loc.device)])
    return C_loc, P_loc


def _global_best(loc_max, loc_arg, m_loc: int, ax: Axes):
    """Combine per-shard (max, argmax) into the global best.

    The tie-break is ``torch.argmax``'s on one device: the lowest global
    index wins (the lowest shard holding the maximum, then its own lowest
    index).  Returns ``(global_max, global_arg, mine)``, ``mine`` marking
    the entries whose winner lives on this shard.
    """
    gmax = pmax(loc_max, ax)
    my = ax.index
    cand = torch.where(loc_max >= gmax, my, 2 ** 30).to(torch.int32)
    mine = pmin(cand, ax) == my
    a = psum(torch.where(mine, loc_arg + my * m_loc, 0).to(torch.int32), ax)
    return gmax, a, mine


def _geometry(U, C):
    dx = U[:, None, 0] - C[None, :, 0]
    dy = U[:, None, 1] - C[None, :, 1]
    dz = U[:, None, 2] - C[None, :, 2]
    d2d = torch.sqrt(dx * dx + dy * dy)
    d3d = torch.sqrt(d2d * d2d + dz * dz)
    return d2d, d3d


def _throughput(se, a, n_cells: int, subband_bw: float, p: float,
                ue_ax: Axes):
    """Fairness allocation with the cell loads reduced over the UE shards."""
    active = se > 0.0
    wgt = torch.where(active, torch.pow(torch.clamp(se, min=1e-12), -p), 0.0)
    denom = torch.zeros((n_cells, se.shape[1]), dtype=se.dtype,
                        device=se.device).index_add_(0, a.long(), wgt)
    denom_i = psum(denom, ue_ax)[a.long()]
    share = torch.where(denom_i > 0.0,
                        wgt / torch.clamp(denom_i, min=1e-30), 0.0)
    return share * subband_bw * se


def _take_col(X, col):
    """``X[i, col[i], :]`` of an (n, m, K) tensor."""
    return torch.gather(X, 1, col.long()[:, None, None].expand(
        -1, 1, X.shape[2]))[:, 0, :]


def _wanted(best_val, best_arg, w_best, m_loc, cell_ax):
    """(a, w): the global attachment and its serving row, gathered from
    the owning cell shard (others add an exact zero)."""
    _, a, mine = _global_best(best_val, best_arg, m_loc, cell_ax)
    return a, psum(torch.where(mine[:, None], w_best, 0.0), cell_ax)


def _sinr_tput(w, u, a, noise_w, n_cells, subband_bw, fairness_p, ue_ax):
    gamma = w / (noise_w + u)
    se = phy.spectral_efficiency(gamma)
    return gamma, _throughput(se, a, n_cells, subband_bw, fairness_p, ue_ax)


class _Layout(NamedTuple):
    mesh: Mesh
    ue: Axes
    cell: Axes
    rows: PartitionSpec     # (n, ...) per-UE rows
    vec: PartitionSpec      # (n,) per-UE scalars
    cells: PartitionSpec    # (m, ...) per-cell rows


def _layout(mesh, ue_axis, cell_axis) -> _Layout:
    ue, cell = _names(ue_axis), _names(cell_axis)
    return _Layout(mesh, mesh.axes(ue), mesh.axes(cell), P(ue, None), P(ue),
                   P(cell, None))


def make_materialized_step(mesh: Mesh, pathgain_fn: Callable, noise_w: float,
                           n_cells: int, subband_bw: float,
                           fairness_p: float, ue_axis=("data",),
                           cell_axis=("model",)):
    """Paper-faithful distributed pipeline: ``f(U, C, Pw) -> (gamma, a,
    tput)`` on global tensors, each rank materialising its UE x cell
    block."""
    L = _layout(mesh, ue_axis, cell_axis)

    def step(U, C, Pw):
        U_loc, C_loc = mesh.block(U, L.rows), mesh.block(C, L.cells)
        P_loc = mesh.block(Pw, L.cells)
        m_loc = C_loc.shape[0]
        d2d, d3d = _geometry(U_loc, C_loc)
        g = pathgain_fn(d2d, d3d, C_loc[None, :, 2], U_loc[:, None, 2])
        r = g[:, :, None] * P_loc[None, :, :]        # local RSRP block
        total = psum(r.sum(dim=1), L.cell)
        wide = r.sum(dim=2)
        loc_arg = torch.argmax(wide, dim=1)      # first max: lowest index
        a, w = _wanted(wide.amax(dim=1), loc_arg.to(torch.int32),
                       _take_col(r, loc_arg), m_loc, L.cell)
        gamma, tput = _sinr_tput(w, total - w, a, noise_w, n_cells,
                                 subband_bw, fairness_p, L.ue)
        return (mesh.unblock(gamma, L.rows), mesh.unblock(a, L.vec),
                mesh.unblock(tput, L.rows))

    return step


def _stream_over_cells(U_loc, C_loc, P_loc, pathgain_fn, tile: int):
    """Online accumulation over cell tiles: ``(total, best_val, best_idx,
    w_best)``.  The running state is O(n_ue_loc); each tile's (n_ue_loc,
    tile, K) block lives for one iteration of the loop."""
    n_rows, k = U_loc.shape[0], P_loc.shape[1]
    dev = U_loc.device
    total = torch.zeros((n_rows, k), device=dev)
    best_val = torch.full((n_rows,), float("-inf"), device=dev)
    best_idx = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    w_best = torch.zeros((n_rows, k), device=dev)
    for t in range(max(1, C_loc.shape[0] // tile)):
        c_tile = C_loc[t * tile:(t + 1) * tile]
        p_tile = P_loc[t * tile:(t + 1) * tile]
        d2d, d3d = _geometry(U_loc, c_tile)
        g = pathgain_fn(d2d, d3d, c_tile[None, :, 2], U_loc[:, None, 2])
        r = g[:, :, None] * p_tile[None, :, :]       # (n_rows, tile, K)
        total = total + r.sum(dim=1)
        wide = r.sum(dim=2)
        t_max, t_arg = wide.amax(dim=1), torch.argmax(wide, dim=1)
        better = t_max > best_val
        best_val = torch.where(better, t_max, best_val)
        best_idx = torch.where(better, (t_arg + t * tile).to(torch.int32),
                               best_idx)
        w_best = torch.where(better[:, None], _take_col(r, t_arg), w_best)
    return total, best_val, best_idx, w_best


def make_streaming_step(mesh: Mesh, pathgain_fn: Callable, noise_w: float,
                        n_cells: int, subband_bw: float, fairness_p: float,
                        ue_axis=("data",), cell_axis=("model",),
                        cell_tile: int = 512):
    """O(N + M)-memory distributed pipeline: ``f(U, C, Pw) -> (gamma, a,
    tput)``, the cell tiles of each shard streamed through one online
    accumulator."""
    L = _layout(mesh, ue_axis, cell_axis)

    def step(U, C, Pw):
        U_loc, C_loc = mesh.block(U, L.rows), mesh.block(C, L.cells)
        P_loc = mesh.block(Pw, L.cells)
        m_loc = C_loc.shape[0]
        tile = min(cell_tile, m_loc)
        C_pad, P_pad = _pad_cells(C_loc, P_loc, tile)
        total, best_val, best_arg, w_best = _stream_over_cells(
            U_loc, C_pad, P_pad, pathgain_fn, tile)
        total = psum(total, L.cell)
        a, w = _wanted(best_val, best_arg, w_best, m_loc, L.cell)
        gamma, tput = _sinr_tput(w, total - w, a, noise_w, n_cells,
                                 subband_bw, fairness_p, L.ue)
        return (mesh.unblock(gamma, L.rows), mesh.unblock(a, L.vec),
                mesh.unblock(tput, L.rows))

    return step


def make_incremental_rows_step(mesh: Mesh, pathgain_fn: Callable,
                               noise_w: float, n_cells: int,
                               subband_bw: float, fairness_p: float,
                               ue_axis=("data",), cell_axis=("model",),
                               cell_tile: int = 512):
    """Smart update at scale: recompute only the moved rows against all
    cells.

    ``f(U, C, Pw, w, u, a, best_val, idx, new_pos) -> (U', w', u', a',
    best_val', tput)`` on global tensors.  The moved indices ``idx`` and
    positions ``new_pos`` are replicated: every shard streams all moved
    rows against its cells and patches the rows it owns.
    """
    L = _layout(mesh, ue_axis, cell_axis)

    def step(U, C, Pw, w, u, a, best_val, idx, new_pos):
        U_loc = mesh.block(U, L.rows).clone()
        C_loc, P_loc = mesh.block(C, L.cells), mesh.block(Pw, L.cells)
        w, u = mesh.block(w, L.rows).clone(), mesh.block(u, L.rows).clone()
        a = mesh.block(a, L.vec).clone()
        best_val = mesh.block(best_val, L.vec).clone()
        n_loc, m_loc = U_loc.shape[0], C_loc.shape[0]
        lo = L.ue.index * n_loc
        local = (idx >= lo) & (idx < lo + n_loc)
        rows = (idx[local] - lo).long()       # the moved rows this shard owns
        U_loc[rows] = new_pos[local]
        # every shard streams all moved rows, so the cell-axis reductions
        # see the same rows on every rank of a cell group
        tile = min(cell_tile, m_loc)
        C_pad, P_pad = _pad_cells(C_loc, P_loc, tile)
        total, bval, barg, w_best = _stream_over_cells(
            new_pos, C_pad, P_pad, pathgain_fn, tile)
        total = psum(total, L.cell)
        bv_rows, a_rows, mine = _global_best(bval, barg, m_loc, L.cell)
        w_rows = psum(torch.where(mine[:, None], w_best, 0.0), L.cell)
        w[rows] = w_rows[local]
        u[rows] = (total - w_rows)[local]
        a[rows] = a_rows[local]
        best_val[rows] = bv_rows[local]
        _, tput = _sinr_tput(w, u, a, noise_w, n_cells, subband_bw,
                             fairness_p, L.ue)
        return (mesh.unblock(U_loc, L.rows), mesh.unblock(w, L.rows),
                mesh.unblock(u, L.rows), mesh.unblock(a, L.vec),
                mesh.unblock(best_val, L.vec), mesh.unblock(tput, L.rows))

    return step
