"""Large-scale fading: 3GPP TR 38.901 LOS probabilities + shadow fading.

* LOS probability per scenario (Table 7.4.2-1): a distance-dependent
  Bernoulli state per (UE, cell) link; :func:`mixed_pathgain` then mixes
  the LOS and NLOS pathloss formulas per link.
* Shadow fading: log-normal with the scenario's sigma_SF (LOS/NLOS
  variants), correlated per site through a shared site component.

Both act as multiplicative factors on the gain matrix.  The sampled
functions take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch

# sigma_SF in dB per (scenario, LOS?) -- TR 38.901 Table 7.4.1-1
SIGMA_SF_DB = {
    ("RMa", True): 4.0, ("RMa", False): 8.0,
    ("UMa", True): 4.0, ("UMa", False): 6.0,
    ("UMi", True): 4.0, ("UMi", False): 7.82,
    ("InH", True): 3.0, ("InH", False): 8.03,
}


def los_probability(scenario: str, d2d):
    """P(LOS) as a function of 2-D distance (TR 38.901 Table 7.4.2-1,
    h_UT <= 13 m forms)."""
    d = torch.clamp(d2d, min=1e-3)
    if scenario == "RMa":
        return torch.where(d <= 10.0, 1.0, torch.exp(-(d - 10.0) / 1000.0))
    if scenario in ("UMa", "UMi"):
        scale = 63.0 if scenario == "UMa" else 36.0
        p = 18.0 / d + torch.exp(-d / scale) * (1.0 - 18.0 / d)
        return torch.where(d <= 18.0, 1.0, p)
    if scenario == "InH":
        return torch.where(d <= 1.2, 1.0,
                           torch.where(d <= 6.5, torch.exp(-(d - 1.2) / 4.7),
                                       torch.exp(-(d - 6.5) / 32.9) * 0.32))
    raise ValueError(scenario)


def sample_los(gen: torch.Generator, scenario: str, d2d, u=None):
    """Bernoulli LOS state per link, (n_ue, n_cell) bool.  ``u`` replaces
    the uniform draw (tests replay the reference's)."""
    if u is None:
        u = torch.rand(d2d.shape, generator=gen, device=gen.device)
    return u < los_probability(scenario, d2d)


def shadow_fading_gain(gen: torch.Generator, scenario: str, los_mask,
                       n_sectors: int = 1, site_corr: float = 0.5,
                       normals=None):
    """Log-normal shadow fading as a linear gain multiplier.

    ``site_corr`` of the variance is shared across a site's sectors; the
    rest is per link.  ``normals`` replaces the two standard-normal draws,
    ``(per_site (n_ue, n_sites), per_link (n_ue, n_cell))``.
    """
    n_ue, n_cell = los_mask.shape
    ns = max(n_sectors, 1)
    n_sites = n_cell // ns
    if normals is None:
        dev = los_mask.device
        normals = (torch.randn((n_ue, n_sites), generator=gen, device=dev),
                   torch.randn((n_ue, n_cell), generator=gen, device=dev))
    per_site, per_link = normals
    per_site = torch.repeat_interleave(per_site, ns, dim=1)[:, :n_cell]
    z = (math.sqrt(site_corr) * per_site
         + math.sqrt(1.0 - site_corr) * per_link)
    sigma = torch.where(los_mask, SIGMA_SF_DB[(scenario, True)],
                        SIGMA_SF_DB[(scenario, False)])
    return torch.pow(10.0, -0.1 * sigma * z * 0.1 * 10)  # 10^(-(sigma z)/10)


def mixed_pathgain(los_model, nlos_model, los_mask, d2d, d3d, h_bs, h_ut):
    """Per-link LOS/NLOS mixture of two pathloss strategies."""
    g_los = los_model.get_pathgain(d2d, d3d, h_bs, h_ut)
    g_nlos = nlos_model.get_pathgain(d2d, d3d, h_bs, h_ut)
    return torch.where(los_mask, g_los, g_nlos)
