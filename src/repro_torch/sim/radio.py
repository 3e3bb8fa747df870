"""The pure-functional radio chain: D -> G -> RSRP -> a -> SINR -> CQI -> SE.

The port of ``repro.sim.radio``: the Figure-1 physics as plain functions
on tensors, shared by the smart-update graph (``core/blocks.py``), the TTI
engine (``mac/engine.py``) and :func:`radio_forward`.

* :class:`RadioConfig` -- the configuration (pathloss/antenna objects,
  noise, frequency grid, fading and reporting knobs);
* :class:`RadioStatic` -- per-deployment tensors (cell positions, power
  matrix, boresights) plus a ``RadioConfig``.

Randomness: every draw takes an explicit ``torch.Generator``
(:func:`draw_fading`); the engine's per-TTI streams live in
``mac.engine.Draws``.

Backends of the dense chain and of the dirty-row update: ``"torch"`` (the
materialised chain; ``None`` means ``"torch"``) and ``"fused"`` (the
hand-written CUDA kernel of ``kernels/fused_sinr`` on CUDA tensors, its
plain version on CPU tensors).  ``"auto"`` is ``"fused"`` exactly when
:func:`fused_unsupported_reason` returns ``None``: a pure function of the
configuration, with no probe and no fallback.  The kernel has no
backward: the fused route raises when autograd records one of its inputs
(``kernels.fused_sinr.grad_unsupported_reason``) and never detaches them;
gradients flow through the ``"torch"`` chain and the relaxations of
:class:`RelaxConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import distributed as mesh_ops
from repro_torch.sim import fading as fading_mod
from repro_torch.sim import phy
from repro_torch.sim.antenna import Antenna_gain

BACKENDS = (None, "auto", "torch", "fused")


class RadioConfig(NamedTuple):
    """Configuration of the radio chain."""

    pathgain_fn: Callable    # (d2d, d3d, h_bs, h_ut) -> linear gain
    antenna: Antenna_gain    # sector pattern (ignored when n_sectors == 1)
    n_sectors: int
    noise_w: float           # noise power per frequency chunk (watts)
    n_subbands: int          # power subbands
    n_rb: int                # physical RBs per subband
    n_rb_subbands: int       # CQI subbands per power subband (1 = wideband)
    coherence_rb: int        # block-fading coherence bandwidth, in RBs
    rayleigh_fading: bool
    attach_ignores_fading: bool   # associate on the long-term mean RSRP
    cqi_wideband: bool       # EESM-pool CQI reports per power subband
    eesm_beta: float

    @property
    def n_freq(self) -> int:
        """Scheduling-frequency chunks (trailing axis of SE/CQI/RSRP)."""
        return self.n_subbands * self.n_rb_subbands


def config_from_params(params, pathgain_fn, antenna) -> RadioConfig:
    """Bind a ``CRRM_parameters`` to concrete pathloss/antenna objects."""
    p = params
    return RadioConfig(
        pathgain_fn=pathgain_fn, antenna=antenna, n_sectors=p.n_sectors,
        noise_w=p.chunk_noise_W, n_subbands=p.n_subbands, n_rb=p.n_rb,
        n_rb_subbands=p.n_rb_subbands, coherence_rb=p.coherence_rb,
        rayleigh_fading=p.rayleigh_fading,
        attach_ignores_fading=p.attach_ignores_fading,
        cqi_wideband=(p.cqi_report == "wideband"),
        eesm_beta=p.cqi_eesm_beta)


@dataclasses.dataclass(frozen=True)
class RadioStatic:
    """Per-deployment radio inputs: tensors + a config."""

    C: Any                   # (n_cells, 3)
    P: Any                   # (n_cells, n_freq) watts
    bore: Any                # (n_cells,) sector boresights, radians
    cfg: RadioConfig


class RadioOutputs(NamedTuple):
    """Everything :func:`radio_forward` derives for one set of positions."""

    G: Any                   # faded gain (n_ue, n_cell[, n_freq]) | None
    rsrp: Any                # (n_ue, n_cell, n_freq) | None
    a: Any                   # (n_ue,) i32 serving-cell attachment
    gamma: Any               # (n_ue, n_freq) linear SINR
    cqi: Any                 # (n_ue, n_freq) at reporting resolution
    mcs: Any                 # (n_ue, n_freq)
    se: Any                  # (n_ue, n_freq) bits/s/Hz


# ---------------------------------------------------------------------------
# composable pure functions (the Figure-1 boxes)
# ---------------------------------------------------------------------------
def compute_distances(U, C):
    """(d2d, d3d, az): 2-D/3-D distances and the cell->UE bearing."""
    dx = U[:, None, 0] - C[None, :, 0]
    dy = U[:, None, 1] - C[None, :, 1]
    dz = U[:, None, 2] - C[None, :, 2]
    d2d = torch.sqrt(dx * dx + dy * dy)
    d3d = torch.sqrt(d2d * d2d + dz * dz)
    az = torch.atan2(dy, dx)
    return d2d, d3d, az


def make_gain_fn(pathgain_fn, antenna: Antenna_gain, n_sectors: int):
    """The link-gain closure: pathloss x sector pattern x fading.  The
    fading factor may carry one extra trailing frequency axis."""
    def gain(d2d, d3d, az, h_ut, h_bs, bore, fad):
        g = pathgain_fn(d2d, d3d, h_bs[None, :], h_ut[:, None])
        if n_sectors > 1:
            g = g * antenna.gain_linear(az, bore)
        if fad.dim() == g.dim() + 1:      # frequency-selective fading
            g = g[..., None]
        return g * fad

    return gain


def pathgains(cfg: RadioConfig, U, C, bore, geom=None):
    """Unfaded linear gain (n_ue, n_cell): pathloss x sector pattern."""
    d2d, d3d, az = compute_distances(U, C) if geom is None else geom
    g = cfg.pathgain_fn(d2d, d3d, C[:, 2][None, :], U[:, 2][:, None])
    if cfg.n_sectors > 1:
        g = g * cfg.antenna.gain_linear(az, bore)
    return g


def apply_fading(G0, fad):
    """Broadcast a fading factor onto an unfaded gain (rank-polymorphic)."""
    if fad.dim() == G0.dim() + 1:
        return G0[..., None] * fad
    return G0 * fad


def rsrp(G, P):
    """R[i, j, k] = p_jk * G_ijk."""
    if G.dim() == 3:
        return G * P[None, :, :]
    return G[:, :, None] * P[None, :, :]


def best_cell(meas, cell_axis=None):
    """The int32 argmax over the cells of (n_ue, n_cell) measurements (the
    first maximum: lowest cell index wins ties, as ``jnp.argmax``).  With
    the cells sharded over ``cell_axis`` (a ``core.distributed.Axes``) the
    columns are this shard's block and the argmax is the global one, with
    the same tie-break."""
    a = torch.argmax(meas, dim=1).to(torch.int32)
    if cell_axis is None:
        return a
    return mesh_ops._global_best(meas.amax(dim=1), a, meas.shape[1],
                                 cell_axis)[1]


def attachment(R, cell_axis=None):
    """Serve each UE from the cell with the largest wideband RSRP."""
    return best_cell(R.sum(dim=2), cell_axis)


def take_cell(X, a, cell_axis=None):
    """``X[i, a_i, ...]``: the serving-cell row under attachment ``a``.

    Cell-sharded (``cell_axis``), ``a`` is global and ``X`` holds this
    shard's cell block: the owning shard gathers the row, every other
    shard adds an exact zero, and one all-reduce SUM gives every shard the
    single-device row."""
    if cell_axis is None:
        col = a.long()
    else:
        lo, m_loc = cell_axis.index * X.shape[1], X.shape[1]
        col = torch.clamp(a.long() - lo, 0, m_loc - 1)
    sel = col.reshape((-1, 1) + (1,) * (X.dim() - 2))
    sel = sel.expand((X.shape[0], 1) + tuple(X.shape[2:]))
    rows = torch.gather(X, 1, sel)[:, 0]
    if cell_axis is None:
        return rows
    mine = ((a >= lo) & (a < lo + m_loc)).reshape(
        (-1,) + (1,) * (rows.dim() - 1))
    return mesh_ops.psum(torch.where(mine, rows, 0), cell_axis)


def cell_total(R, cell_axis=None):
    """sum_j R[i, j, k]: summed over the cell shards when sharded."""
    total = R.sum(dim=1)
    return total if cell_axis is None else mesh_ops.psum(total, cell_axis)


def wanted(R, a):
    """w[i, k]: the serving cell's RSRP per frequency chunk."""
    return take_cell(R, a)


def interference(R, w):
    """u[i, k] = sum_j R[i, j, k] - w[i, k]."""
    return R.sum(dim=1) - w


def sinr_from_wu(w, u, noise_w: float):
    """gamma = w / (noise + u), linear."""
    return w / (noise_w + u)


def sinr(R, a, noise_w: float, cell_axis=None):
    """(gamma, w, u) for serving assignment ``a`` (cell-sharded: the
    owning shard's serving row and the interference total summed over the
    shards, which reorders its float sum)."""
    w = take_cell(R, a, cell_axis)
    u = cell_total(R, cell_axis) - w
    return sinr_from_wu(w, u, noise_w), w, u


def quantize_cqi(gamma):
    """Per-chunk CQI quantisation of a linear SINR tensor."""
    return phy.sinr_db_to_cqi(phy.sinr_to_db(gamma))


def pool_report(gamma, n_rb_subbands: int, eesm_beta: float = 1.0):
    """Effective SINR per power subband (EESM), broadcast back onto the
    full frequency grid: gamma_eff = -beta * log(mean_k exp(-gamma_k / beta)).
    """
    s = n_rb_subbands
    shp = gamma.shape
    g = gamma.reshape(shp[:-1] + (shp[-1] // s, s))
    eff = -eesm_beta * (torch.logsumexp(-g / eesm_beta, dim=-1)
                        - float(np.log(np.float32(s))))
    return eff[..., None].expand(eff.shape + (s,)).reshape(shp)


def cqi_report(gamma, n_rb_subbands: int, wideband: bool,
               eesm_beta: float = 1.0):
    """CQI at the configured reporting resolution (``cqi_report`` knob)."""
    if wideband and n_rb_subbands > 1:
        return quantize_cqi(pool_report(gamma, n_rb_subbands, eesm_beta))
    return quantize_cqi(gamma)


def cqi_of(cfg: RadioConfig, gamma):
    return cqi_report(gamma, cfg.n_rb_subbands, cfg.cqi_wideband,
                      cfg.eesm_beta)


def mcs_of(cqi):
    return phy.cqi_to_mcs(cqi)


def se_of(mcs, cqi):
    """Spectral efficiency of the selected MCS, zeroed at CQI 0."""
    return torch.where(cqi > 0, phy.mcs_to_efficiency(mcs), 0.0)


def se_chain(cfg: RadioConfig, gamma):
    """(se, cqi) from a linear SINR tensor, at reporting resolution."""
    cqi = cqi_of(cfg, gamma)
    return se_of(mcs_of(cqi), cqi), cqi


# ---------------------------------------------------------------------------
# differentiable relaxations
# ---------------------------------------------------------------------------
class RelaxConfig(NamedTuple):
    """Flags selecting soft relaxations of the MAC chain.

    The forward chain has three non-differentiable points: argmax
    attachment, the CQI staircase and the max_cqi scheduler's
    winner-take-all.  Each has its own relaxation; ``relax=None`` is the
    exact legacy chain.  Hashable, so it keys the ``episode_fns_for``
    cache like :class:`RadioConfig`.

    * ``soft_attach`` -- the wanted/interference split under a
      temperature-``attach_tau`` softmax over per-cell log-RSRP; the
      scheduling attachment stays the hard argmax.
    * ``cqi_mode`` -- ``"soft"``: SE from
      :func:`phy.soft_spectral_efficiency`; ``"ste"``: straight-through,
      the hard SE forward and the soft surrogate's gradient
      (``soft + (hard - soft).detach()``); ``"hard"``: the staircase.
    * ``soft_sched`` -- max_cqi's winner-take-all becomes a
      temperature-``sched_tau`` softmax share over each cell's active UEs
      (pf is already smooth, rr does not read the CQI).
    """

    soft_attach: bool = True
    attach_tau: float = 0.1       # log-RSRP softmax temperature
    cqi_mode: str = "soft"        # "soft" | "ste" | "hard"
    se_sharpness: float = 2.0     # sigmoid slope of the soft staircase, /dB
    soft_sched: bool = True
    sched_tau: float = 1.0        # SE-softmax temperature (bits/s/Hz scale)


def soft_attach_sinr(R, meas, tau: float, noise_w: float):
    """gamma under softmax attachment: weights ``softmax(log meas / tau)``
    over the cells of each UE, ``w = sum_j p_ij R[i, j, :]`` and ``u =
    sum_j R[i, j, :] - w``.  ``meas`` is the (n_ue, n_cell) wideband
    measurement the hard argmax ranks; as ``tau -> 0`` this is
    :func:`sinr`."""
    logits = torch.log(torch.clamp(meas, min=1e-30)) / tau
    p = torch.softmax(logits, dim=1)                       # (n_ue, n_cell)
    w = torch.einsum("uc,ucf->uf", p, R)
    u = R.sum(dim=1) - w
    return sinr_from_wu(w, u, noise_w)


def se_chain_relaxed(cfg: RadioConfig, gamma, relax: "RelaxConfig | None"):
    """(se, cqi): :func:`se_chain` with the CQI staircase relaxed.

    ``relax=None`` and ``cqi_mode="hard"`` are :func:`se_chain` itself.  The
    reported ``cqi`` stays the hard int32 CQI in every mode; only the SE
    softens.
    """
    if relax is None or relax.cqi_mode == "hard":
        return se_chain(cfg, gamma)
    if cfg.cqi_wideband and cfg.n_rb_subbands > 1:
        gamma = pool_report(gamma, cfg.n_rb_subbands, cfg.eesm_beta)
    cqi = quantize_cqi(gamma)
    soft = phy.soft_spectral_efficiency(gamma, relax.se_sharpness)
    if relax.cqi_mode == "ste":
        hard = se_of(mcs_of(cqi), cqi)
        return soft + (hard - soft).detach(), cqi
    return soft, cqi


# ---------------------------------------------------------------------------
# THE dirtiness convention: a dirty-row set is a fixed-size index vector
# padded with a repeated valid row, so a padded row recomputes and writes
# its own value again (idempotent) -- no masks.
# ---------------------------------------------------------------------------
def pad_indices(rows) -> np.ndarray:
    """Pad a host-side dirty-row index set to the next power-of-two bucket,
    repeating the first index."""
    idx = np.asarray(sorted(rows), dtype=np.int32)
    n = len(idx)
    bucket = 1 << max(0, (n - 1).bit_length())
    if bucket > n:
        idx = np.concatenate([idx, np.full(bucket - n, idx[0], np.int32)])
    return idx


def dirty_indices(mask, budget: int):
    """Compact a boolean dirty mask to a ``budget``-sized int32 index vector:
    the True rows in ascending order, padded with row 0."""
    n = mask.shape[0]
    k = min(budget, n)
    score = torch.where(mask, n - torch.arange(n, dtype=torch.int32,
                                               device=mask.device), 0)
    vals, idx = torch.topk(score, k)
    idx = torch.where(vals > 0, idx, 0).to(torch.int32)
    if budget > n:                       # degenerate: pad beyond the axis
        idx = torch.cat([idx, torch.zeros((budget - n,), dtype=torch.int32,
                                          device=mask.device)])
    return idx


def window_indices(start, n_move: int, n: int, *, offset=0, n_loc=None):
    """Exact-count dirty rows of the circular mover window
    ``[start, start + n_move) mod n``, in O(n_move).  Rows outside
    ``[offset, offset + n_loc)`` pad with row 0.  Returns ``(idx, count)``
    (int32 index vector, number of genuinely dirty rows)."""
    n_loc = n if n_loc is None else n_loc
    dev = start.device if isinstance(start, torch.Tensor) else "cpu"
    if n_move >= n_loc:
        return (torch.arange(n_loc, dtype=torch.int32, device=dev),
                torch.tensor(n_loc, dtype=torch.int32, device=dev))
    g = torch.remainder(start + torch.arange(n_move, dtype=torch.int32,
                                             device=dev), n)
    local = g - offset
    valid = (local >= 0) & (local < n_loc)
    return (torch.where(valid, local, 0).to(torch.int32),
            valid.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# the incremental (smart-update) path
# ---------------------------------------------------------------------------
class RadioState(NamedTuple):
    """The carried radio tensors of the incremental path (``None`` where the
    regime does not need a leaf)."""

    meas: Any        # (n_ue, n_cell) wideband measurement RSRP | None
    a: Any           # (n_ue,) i32 attachment | None
    se: Any          # (n_ue, n_freq) | None
    cqi: Any         # (n_ue, n_freq) | None
    se_all: Any      # (n_ue, n_cell, n_freq) | None
    cqi_all: Any     # (n_ue, n_cell, n_freq) | None
    G: Any           # faded gain (n_ue, n_cell[, n_freq]) | None
    G0: Any          # unfaded gain (n_ue, n_cell) | None


def _chain_rows(cfg: RadioConfig, U_rows, C, bore, fad_rows, P, *,
                with_tables: bool, with_gain: bool,
                cell_axis=None) -> RadioState:
    """The D->G->RSRP->a->SINR->CQI->SE chain for a slab of UE rows.

    Row-local: every output row depends only on its own position/fading
    row, which is what makes the scatter-patch exact.  ``cell_axis`` (a
    ``core.distributed.Axes``) shards the cells: ``C``/``bore``/``P`` and
    the fading columns are this shard's block, the attachment is the
    cross-shard argmax and the interference total is summed over the
    shards.
    """
    G0 = pathgains(cfg, U_rows, C, bore)
    # fad_rows=None: the unfaded channel (G0 * ones is bitwise G0)
    G = G0 if fad_rows is None else apply_fading(G0, fad_rows)
    R = rsrp(G, P)
    if cfg.rayleigh_fading and cfg.attach_ignores_fading:
        meas = rsrp(G0, P).sum(dim=2)      # long-term association (L3)
    else:
        meas = R.sum(dim=2)
    a = best_cell(meas, cell_axis)
    se = cqi = se_all = cqi_all = None
    if with_tables:
        # the serving cell is carried MAC state (A3): tabulate the SINR
        # chain for every candidate cell so a later handover is a gather
        total = cell_total(R, cell_axis)
        gamma_all = R / (cfg.noise_w + (total[:, None, :] - R))
        se_all, cqi_all = se_chain(cfg, gamma_all)
    else:
        gamma, _, _ = sinr(R, a, cfg.noise_w, cell_axis)
        se, cqi = se_chain(cfg, gamma)
    return RadioState(meas=meas if with_tables else None,
                      a=None if with_tables else a, se=se,
                      cqi=cqi, se_all=se_all, cqi_all=cqi_all,
                      G=G if with_gain else None,
                      G0=G0 if (with_gain and cfg.rayleigh_fading
                                and cfg.attach_ignores_fading) else None)


def radio_init(cfg: RadioConfig, U, C, bore, fad, P, *,
               with_tables: bool = False, with_gain: bool = False,
               cell_axis=None) -> RadioState:
    """Full-width :class:`RadioState`: the everything-dirty base case."""
    return _chain_rows(cfg, U, C, bore, fad, P, with_tables=with_tables,
                       with_gain=with_gain, cell_axis=cell_axis)


def _scatter(old, idx, new_rows):
    """Write ``new_rows`` into ``old`` at ``idx`` in place (the carried
    state is owned by its caller; duplicate padded indices write equal
    values)."""
    if old is None:
        return None
    old[idx] = new_rows
    return old


def radio_update_rows(cfg: RadioConfig, state: RadioState, U, C, bore,
                      fad, P, idx, *, cell_axis=None) -> RadioState:
    """Recompute the chain for UE rows ``idx`` and scatter them into
    ``state`` in place.  ``idx`` follows the dirtiness convention
    (:func:`dirty_indices` / :func:`pad_indices`); ``fad=None`` selects
    the unfaded chain."""
    idx = idx.long()
    fad_rows = None if fad is None else fad[idx]
    rows = _chain_rows(cfg, U[idx], C, bore, fad_rows, P,
                       with_tables=state.se_all is not None,
                       with_gain=state.G is not None, cell_axis=cell_axis)
    return RadioState(*(_scatter(o, idx, n) for o, n in zip(state, rows)))


def radio_update_rows_fused(cfg: RadioConfig, state: RadioState, U, C, bore,
                            fad, P, idx) -> RadioState:
    """:func:`radio_update_rows` through the fused kernel.

    Runs ``kernels.ops.fused_sinr`` on the dirty rows ``idx`` (int32 or
    int64) of the full positions and fading against all cells -- the CUDA
    kernel reads the rows by index on CUDA tensors, its plain version
    gathers them on CPU tensors -- and scatters the a/se/cqi rows back.
    Handover tables (``se_all``) and carried gains (``G``) need
    O(n_cell)-per-row outputs the streaming kernel never produces, so those
    regimes raise.
    """
    if state.se_all is not None or state.G is not None:
        raise ValueError(
            "the fused dirty-row backend carries only the O(n_ue) "
            "RadioState (a/se/cqi); handover tables (se_all) and carried "
            "gains (G) need the torch row recompute (radio_update_rows)")
    reason = fused_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(f"the fused kernel cannot express this "
                         f"configuration: {reason}")
    from repro_torch.kernels import ops
    gamma, a_rows, _, _ = ops.fused_sinr(
        U, C, P, pathgain_fn=cfg.pathgain_fn, noise_w=cfg.noise_w,
        boresight=bore, fad=fad, idx=idx,
        attach_on_mean=(fad is not None and cfg.rayleigh_fading
                        and cfg.attach_ignores_fading),
        n_sectors=cfg.n_sectors)
    se_rows, cqi_rows = se_chain(cfg, gamma)
    rows = RadioState(meas=None, a=a_rows, se=se_rows, cqi=cqi_rows,
                      se_all=None, cqi_all=None, G=None, G0=None)
    idx = idx.long()
    return RadioState(*(_scatter(o, idx, n) for o, n in zip(state, rows)))


def radio_update_cells(cfg: RadioConfig, state: RadioState, P,
                       dirty_cell_mask, *, cell_axis=None,
                       backend=None) -> RadioState:
    """Apply a per-cell power delta from the carried gain matrices
    (``with_gain=True``): every per-UE output recomputes without geometry
    or pathloss, and is selected against the carried one on
    ``dirty_cell_mask.any()`` (branch-free, no host sync).  The carried
    gains come back as they are (the row update patches them in place).
    ``cell_axis`` shards the cells as in :func:`_chain_rows` (the carried
    gains and ``P`` are this shard's block; ``dirty_cell_mask`` is
    replicated).

    ``backend="auto"`` re-prices in one pass of ``kernels.ops.reprice_cells``
    (the CUDA kernel on CUDA tensors, its plain version on CPU tensors)
    where the state carries no handover tables and the cells are not
    sharded; ``SE``/``CQI`` then follow from its ``gamma`` in torch.  Every
    other backend, the tables and a cell-sharded mesh take the torch
    re-pricing."""
    attach_on_mean = cfg.rayleigh_fading and cfg.attach_ignores_fading
    if backend == "auto" and state.se_all is None and cell_axis is None:
        from repro_torch.kernels import ops
        a, gamma = ops.reprice_cells(state.G, P.contiguous(), cfg.noise_w,
                                     state.G0 if attach_on_mean else None)
        se, cqi = se_chain(cfg, gamma)
        new = state._replace(a=a, se=se, cqi=cqi)
    else:
        R = rsrp(state.G, P)
        if attach_on_mean:
            meas = rsrp(state.G0, P).sum(dim=2)
        else:
            meas = R.sum(dim=2)
        a = best_cell(meas, cell_axis)
        se = cqi = se_all = cqi_all = None
        if state.se_all is not None:
            total = cell_total(R, cell_axis)
            gamma_all = R / (cfg.noise_w + (total[:, None, :] - R))
            se_all, cqi_all = se_chain(cfg, gamma_all)
            a = None
        else:
            gamma, _, _ = sinr(R, a, cfg.noise_w, cell_axis)
            se, cqi = se_chain(cfg, gamma)
        new = state._replace(meas=meas, a=a, se=se, cqi=cqi, se_all=se_all,
                             cqi_all=cqi_all)
    any_dirty = torch.any(dirty_cell_mask)
    return RadioState(*(o if o is None or n is o
                        else torch.where(any_dirty, n, o)
                        for n, o in zip(new, state)))


def radio_update(static: RadioStatic, state: RadioState, U,
                 dirty_ue_mask, dirty_cell_mask=None, *, budget: int,
                 fad=None, P=None, window=None) -> RadioState:
    """One smart update: dirty UE rows + (optionally) dirty cell columns.

    ``dirty_ue_mask`` compacts to a ``budget``-sized index vector; or
    ``window=(start, n)`` declares the dirty rows to be the circular window
    ``[start, start + n) mod n_ue``.
    """
    cfg = static.cfg
    P = static.P if P is None else P
    if window is not None:
        start, n_win = window
        if n_win > budget:
            raise ValueError(f"window size {n_win} exceeds budget {budget}")
        idx, _ = window_indices(start, n_win, U.shape[0])
        if n_win < budget:               # same static shape as the mask path
            idx = torch.cat([idx, torch.zeros((budget - n_win,),
                                              dtype=torch.int32,
                                              device=idx.device)])
    else:
        idx = dirty_indices(dirty_ue_mask, budget)
    state = radio_update_rows(cfg, state, U, static.C, static.bore,
                              fad, P, idx)
    if dirty_cell_mask is not None:
        state = radio_update_cells(cfg, state, P, dirty_cell_mask)
    return state


# ---------------------------------------------------------------------------
# fading
# ---------------------------------------------------------------------------
def draw_fading(cfg: RadioConfig, gen: torch.Generator, n_ues: int,
                n_cells: int, dtype=torch.float32):
    """THE fading draw on ``gen``'s device: (n_ues, n_cells) wideband
    Rayleigh, or (n_ues, n_cells, n_freq) subband block fading when
    ``n_rb_subbands > 1``."""
    if cfg.n_rb_subbands > 1:
        return fading_mod.subband_rayleigh_power(
            gen, n_ues, n_cells, cfg.n_subbands * cfg.n_rb,
            cfg.coherence_rb, cfg.n_freq, dtype)
    return fading_mod.rayleigh_power(gen, (n_ues, n_cells), dtype)


def unit_fading(cfg: RadioConfig, n_ues: int, n_cells: int,
                dtype=torch.float32, device="cpu"):
    """The no-fading factor (all ones)."""
    return torch.ones((n_ues, n_cells), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# the one-call forward pass
# ---------------------------------------------------------------------------
_STOCK_SECTOR = {"phi_3dB_deg": 65.0, "A_max_dB": 30.0, "max_gain_dBi": 0.0}


def fused_unsupported_reason(cfg: RadioConfig) -> "str | None":
    """``None`` when the fused kernel covers the configuration, else why
    not.  Every fading layout is expressible; a non-stock sector pattern
    and a pathloss callable outside ``PATHLOSS_MODELS`` are not."""
    if cfg.n_sectors > 1:
        for knob, want in _STOCK_SECTOR.items():
            have = getattr(cfg.antenna, knob, want)
            if abs(have - want) > 1e-6:
                return (f"non-stock sector pattern: antenna.{knob}={have!r} "
                        f"(the kernel inlines the stock 3GPP pattern, "
                        f"{knob}={want}); use the torch backend")
    if not hasattr(cfg.pathgain_fn, "kernel_spec"):
        return (f"pathgain_fn {cfg.pathgain_fn!r} is not a model of "
                f"repro_torch.sim.pathloss.PATHLOSS_MODELS, the only "
                f"pathloss the kernel implements; use the torch backend")
    return None


def _forward_fused(static: RadioStatic, positions, P,
                   fad=None) -> RadioOutputs:
    """Dense chain through the fused kernel: G/rsrp are never materialised."""
    from repro_torch.kernels import ops
    cfg = static.cfg
    gamma, a, _, _ = ops.fused_sinr(
        positions, static.C, P, pathgain_fn=cfg.pathgain_fn,
        noise_w=cfg.noise_w, boresight=static.bore, fad=fad,
        attach_on_mean=(fad is not None and cfg.rayleigh_fading
                        and cfg.attach_ignores_fading),
        n_sectors=cfg.n_sectors)
    cqi = cqi_of(cfg, gamma)
    mcs = mcs_of(cqi)
    return RadioOutputs(G=None, rsrp=None, a=a, gamma=gamma, cqi=cqi,
                        mcs=mcs, se=se_of(mcs, cqi))


def resolve_backend(backend, cfg: RadioConfig) -> bool:
    """True when ``backend`` selects the fused kernel for ``cfg``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "fused":
        reason = fused_unsupported_reason(cfg)
        if reason is not None:
            raise ValueError(f"backend='fused' cannot express this "
                             f"configuration: {reason}")
        return True
    return backend == "auto" and fused_unsupported_reason(cfg) is None


def radio_forward(static: RadioStatic, positions, fad=None, fading_gen=None,
                  P=None, backend=None) -> RadioOutputs:
    """The whole radio chain as one call.

    The fading factor comes from ``fad`` (an explicit tensor), from
    ``fading_gen`` (a fresh :func:`draw_fading`, honouring
    ``cfg.rayleigh_fading``) or defaults to none.  ``P`` overrides the
    static power matrix.  ``backend``: ``None``/``"torch"`` materialises
    the chain; ``"fused"`` runs the fused kernel (``G``/``rsrp`` are then
    ``None``) and raises where it cannot express the configuration or
    where autograd records an input (the kernel has no backward);
    ``"auto"`` is ``"fused"`` iff :func:`fused_unsupported_reason` is
    ``None``.
    """
    cfg = static.cfg
    P = static.P if P is None else P
    n_ue, n_cell = positions.shape[0], static.C.shape[0]
    if fad is None and fading_gen is not None and cfg.rayleigh_fading:
        fad = draw_fading(cfg, fading_gen, n_ue, n_cell)
    if resolve_backend(backend, cfg):
        return _forward_fused(static, positions, P, fad=fad)
    if fad is None:
        fad = unit_fading(cfg, n_ue, n_cell, device=positions.device)
    d2d, d3d, az = compute_distances(positions, static.C)
    gain = make_gain_fn(cfg.pathgain_fn, cfg.antenna, cfg.n_sectors)
    h_ut, h_bs = positions[:, 2], static.C[:, 2]
    G = gain(d2d, d3d, az, h_ut, h_bs, static.bore, fad)
    R = rsrp(G, P)
    if cfg.rayleigh_fading and cfg.attach_ignores_fading:
        # association on the long-term mean
        G0 = gain(d2d, d3d, az, h_ut, h_bs, static.bore,
                  unit_fading(cfg, n_ue, n_cell, device=positions.device))
        a = attachment(rsrp(G0, P))
    else:
        a = attachment(R)
    gamma, _, _ = sinr(R, a, cfg.noise_w)
    cqi = cqi_of(cfg, gamma)
    mcs = mcs_of(cqi)
    return RadioOutputs(G=G, rsrp=R, a=a, gamma=gamma, cqi=cqi,
                        mcs=mcs, se=se_of(mcs, cqi))
