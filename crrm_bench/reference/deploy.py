"""Network deployment generators: PPP fields and hexagonal site grids."""
from __future__ import annotations

import torch


def ppp_points(gen: torch.Generator, n_points: int, extent_m: float,
               z: float = 0.0):
    """n_points uniform in a square [0, extent)^2 at height z, drawn from
    ``gen`` on the generator's device."""
    xy = torch.rand((n_points, 2), generator=gen, device=gen.device) * extent_m
    zcol = torch.full((n_points, 1), z, device=gen.device)
    return torch.cat([xy, zcol], dim=1)


def hex_sites(rings: int, isd_m: float, z: float = 25.0, device="cpu"):
    """Hexagonal grid of sites: centre + ``rings`` rings, inter-site ``isd_m``.

    Returns (n_sites, 3) float32.  n_sites = 1 + 3*rings*(rings+1).
    """
    pts = []
    R = rings
    for q in range(-R, R + 1):
        for r in range(max(-R, -q - R), min(R, -q + R) + 1):
            x = isd_m * (q + r / 2.0)
            y = isd_m * r * 0.8660254037844386  # sqrt(3)/2
            pts.append((x, y, z))
    arr = torch.tensor(pts, dtype=torch.float32, device=device)
    if arr.shape[0] != 1 + 3 * rings * (rings + 1):
        raise AssertionError(f"hex grid of {rings} rings has {arr.shape[0]} sites")
    return arr


def replicate_sectors(sites_xyz, n_sectors: int):
    """Cells = sites repeated per sector (co-located, different boresights)."""
    return torch.repeat_interleave(sites_xyz, n_sectors, dim=0)
