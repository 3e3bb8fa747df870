"""Plain PyTorch oracles for the port's kernels (the correctness references).

The counterpart of ``repro.kernels.ref``: thin delegations into the port's
own radio chain (``repro_torch.sim.radio``), so a kernel-vs-reference check
also cross-validates the kernel against every other consumer of the chain.
"""
from __future__ import annotations

from repro_torch.sim import radio


def pairwise_dist_ref(U, C):
    """(d2d, d3d) for UE rows x cell columns (``radio.compute_distances``)."""
    d2d, d3d, _ = radio.compute_distances(U, C)
    return d2d, d3d


def fused_sinr_ref(U, C, Pw, pathgain_fn, noise_w):
    """Materialised reference for the fused pipeline.

    Returns (gamma, a, w, u): per-UE-per-subband SINR, serving cell,
    wanted and unwanted power -- the radio chain's unfaded
    D -> G -> RSRP -> a -> w/u -> gamma composition.  Attachment = argmax
    of wideband RSRP, ties broken toward the lowest cell index (as
    ``torch.argmax``, and the kernel's tie-break).
    """
    d2d, d3d, _ = radio.compute_distances(U, C)
    g = pathgain_fn(d2d, d3d, C[None, :, 2], U[:, None, 2])
    r = radio.rsrp(g, Pw)                          # (N, M, K)
    a = radio.attachment(r)
    gamma, w, u = radio.sinr(r, a, noise_w)
    return gamma, a, w, u
