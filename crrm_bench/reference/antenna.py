"""3GPP horizontal antenna pattern (TR 36.814 / 38.901 style).

A(phi) = -min(12 (phi/phi_3dB)^2, A_max) dB, phi_3dB = 65 deg, A_max = 30 dB.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def wrap_angle(phi):
    """Wrap angle to (-pi, pi]."""
    return torch.atan2(torch.sin(phi), torch.cos(phi))


def deg2rad_f32(deg: float) -> float:
    """``deg * pi/180`` rounded in float32, as ``jnp.deg2rad`` computes it."""
    return float(np.float32(deg) * np.float32(math.pi / 180.0))


@dataclasses.dataclass(frozen=True)
class Antenna_gain:
    """3GPP horizontal pattern, one boresight per cell."""

    phi_3dB_deg: float = 65.0
    A_max_dB: float = 30.0
    max_gain_dBi: float = 0.0  # peak element gain added on boresight

    def pattern_dB(self, phi_off_boresight):
        """phi in radians, relative to boresight."""
        phi_3db = deg2rad_f32(self.phi_3dB_deg)
        att = torch.clamp(12.0 * (phi_off_boresight / phi_3db) ** 2,
                          max=self.A_max_dB)
        return self.max_gain_dBi - att

    def gain_dB(self, azimuth_ue, boresight):
        """azimuth_ue: (n_ue, n_cell) bearing cell->UE; boresight: (n_cell,)."""
        off = wrap_angle(azimuth_ue - boresight[None, :])
        return self.pattern_dB(off)

    def gain_linear(self, azimuth_ue, boresight):
        return torch.pow(10.0, 0.1 * self.gain_dB(azimuth_ue, boresight))


def sector_boresights(n_sites: int, n_sectors: int, device="cpu"):
    """Boresight angles for ``n_sites`` sites of ``n_sectors`` cells each.

    Cell j = site j // n_sectors, sector j % n_sectors, pointing at
    s * 2*pi/n_sectors.  Returns (n_sites * n_sectors,) float32 radians.
    """
    sector = torch.arange(n_sites * n_sectors, device=device) % n_sectors
    return sector.to(torch.float32) * (2.0 * math.pi / n_sectors)
