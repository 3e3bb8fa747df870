"""PHY abstractions: SINR -> CQI -> MCS -> spectral efficiency.

The tables of ``repro.sim.phy`` as float32 tensors; every function takes
its tables from the device of its input (one cached copy per device, so a
TTI loop does no host-to-device copies).
"""
from __future__ import annotations

import functools

import torch

# SINR (dB) above which CQI index i (1..15) is usable; CQI 0 = out of range.
CQI_SINR_THRESHOLDS_DB = (
    -3.25, -0.86, 1.22, 2.16, 3.78, 4.51, 6.42, 8.34, 8.92, 10.55, 12.49,
    13.45, 15.42, 17.27, 18.63)

# TS 38.214 Table 5.2.2.1-2 CQI spectral efficiencies (CQI 0..15).
CQI_EFFICIENCY = (
    0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
    1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547)

# TS 38.214 Table 5.1.3.1-1 (64QAM) spectral efficiencies, MCS 0..28.
MCS_EFFICIENCY = (
    0.2344, 0.3066, 0.3770, 0.4902, 0.6016, 0.7402, 0.8770, 1.0273,
    1.1758, 1.3262, 1.3281, 1.4766, 1.6953, 1.9141, 2.1602, 2.4063,
    2.5703, 2.5664, 2.7305, 3.0293, 3.3223, 3.6094, 3.9023, 4.2129,
    4.5234, 4.8164, 5.1152, 5.3320, 5.5547)


@functools.lru_cache(maxsize=None)
def table(name: str, device: torch.device) -> torch.Tensor:
    """One of the module's tables as a float32 tensor on ``device``."""
    return torch.tensor(globals()[name], dtype=torch.float32, device=device)


#: 1/ln(10): log10 is taken as log(x) * (1/ln 10), the form jnp.log10 has
INV_LN10 = 0.4342944920063019


def sinr_to_db(sinr_linear):
    return 10.0 * (torch.log(torch.clamp(sinr_linear, min=1e-12)) * INV_LN10)


def sinr_db_to_cqi(sinr_db):
    """CQI in [0, 15]: number of thresholds passed (look-up table)."""
    thr = table("CQI_SINR_THRESHOLDS_DB", sinr_db.device)
    return (sinr_db[..., None] >= thr).sum(dim=-1, dtype=torch.int32)


def cqi_to_mcs(cqi):
    """The paper: MCS is a scaled version of CQI, values in [0, 28]."""
    return torch.clamp(torch.round(cqi.to(torch.float32) * 28.0 / 15.0),
                       0, 28).to(torch.int32)


def mcs_to_efficiency(mcs):
    """bits/s/Hz for each MCS index (3GPP tables)."""
    return table("MCS_EFFICIENCY", mcs.device)[
        torch.clamp(mcs, 0, 28).long()]


def spectral_efficiency(sinr_linear):
    """Full chain SINR -> CQI -> MCS -> spectral efficiency, zeroed at CQI 0."""
    cqi = sinr_db_to_cqi(sinr_to_db(sinr_linear))
    se = mcs_to_efficiency(cqi_to_mcs(cqi))
    return torch.where(cqi > 0, se, 0.0)
