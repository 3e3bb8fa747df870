"""Public wrappers over the port's kernels: pairwise distances, the
fused SINR pipeline and the fault re-pricing over the carried gain.

The counterpart of ``repro.kernels.ops``.  The CUDA kernels mask ragged
edges themselves, so unlike the TPU wrappers nothing is padded here and
there are no tile arguments.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_sinr as _fused
from repro_torch.kernels import pairwise_dist as _dist
from repro_torch.kernels import reprice_cells as _reprice


def pairwise_dist(U, C):
    """(d2d, d3d): the (N, M) 2-D and 3-D distances of UE rows ``U`` (N, 3)
    and cells ``C`` (M, 3).  CUDA tensors launch the kernel."""
    return _dist.pairwise_dist(U, C)


def fused_sinr(U, C, Pw, *, pathgain_fn, noise_w: float, boresight=None,
               fad=None, attach_on_mean: bool = False, n_sectors: int = 1,
               idx=None):
    """Fused D->G->RSRP->w/u->SINR pipeline: returns (gamma, a, w, u).

    ``a`` is the (R,) int32 attachment, ``w``/``u`` the (R, K) wanted and
    interference powers, ``gamma = w / (noise + u)``.  ``fad`` streams
    per-link fading -- (N, M) wideband or (N, M, K) per-RB -- and
    ``attach_on_mean`` attaches on the unfaded RSRP row sum.  ``idx`` (R,)
    selects UE rows of ``U`` and ``fad`` (R = N without it): the dirty-row
    incremental backend passes its dirty rows and scatters the returned
    rows back (``radio.radio_update_rows_fused``); nothing is gathered.
    """
    if boresight is None:
        boresight = torch.zeros((C.shape[0],), dtype=torch.float32,
                                device=C.device)
    total, _, barg, wbest = _fused.fused_sinr_accumulate(
        U, C, Pw, boresight.reshape(-1).contiguous(), fad, idx=idx,
        pathgain_fn=pathgain_fn, n_sectors=n_sectors,
        attach_on_mean=attach_on_mean)
    u = total - wbest
    gamma = wbest / (noise_w + u)
    return gamma, barg[:, 0], wbest, u


def reprice_cells(G, P, noise_w: float, G0=None):
    """(a, gamma): every UE row of the carried gain ``G`` (N, M) or
    (N, M, K) re-priced under the powers ``P`` (M, K) in one pass.

    ``a`` is the (N,) int32 lowest-index argmax of the measurement (of the
    unfaded ``G0`` (N, M) where it is given), ``gamma`` the (N, K) SINR
    against it.  The fault path of the incremental engine calls it
    (``radio.radio_update_cells``) on every TTI of a fault run."""
    return _reprice.reprice_cells(G, P, noise_w, G0)
