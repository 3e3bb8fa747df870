"""3GPP TR 38.901 pathloss models (RMa, UMa, UMi, InH) + power-law.

The models of ``repro.sim.pathloss`` on torch tensors: each is a strategy
object with ``get_pathloss_dB(d2d, d3d, h_bs, h_ut)`` and ``get_pathgain``
(also its ``__call__``).  Heights may be tensors that broadcast against the
distances or Python floats.

Each model can also describe itself to the fused CUDA kernel
(``kernels/fused_sinr``) as ``kernel_spec() -> (model_id, params)``: a
model id from the ``PL_*`` constants and a short tuple of floats that the
kernel's family for that model reads.  The constants are folded here in
float64 into a log2-gain form, ``log2 g = -0.1 log2(10) * pathloss_dB``,
in which a pathloss of ``b * lg(d3d)`` dB becomes ``-b/20 * log2(d3d^2)``:
a link then costs the kernel one log of d3d^2 and one exp2.  The layouts
of the tuples are fixed here and in ``kernels/csrc/fused_sinr.cu``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

C_LIGHT = 299_792_458.0  # m/s

# model ids of the fused kernel (kernels/csrc/fused_sinr.cu)
PL_RMA = 0
PL_RMA_DISCRETISED = 1
PL_UMA = 2
PL_UMI = 3
PL_INH = 4
PL_POWER_LAW = 5


#: log2(gain) = -LOG2_GAIN_PER_DB * pathloss(dB)
LOG2_GAIN_PER_DB = 0.1 * math.log2(10.0)


def _l2g(pl_db: float) -> float:
    """A pathloss term in dB as a log2-gain term (float64)."""
    return -LOG2_GAIN_PER_DB * pl_db


def _slope(db_per_decade: float) -> float:
    """``b * lg(d3d)`` dB as the coefficient of ``log2(d3d^2)`` in log2
    gain: ``-S b lg(d) = -b/20 log2(d^2)``."""
    return -0.05 * db_per_decade


def db_to_gain(pl_db):
    """Linear power gain from a pathloss in dB (positive pl_db = loss)."""
    return torch.pow(10.0, -0.1 * pl_db)


#: 1/ln(10): log10 is taken as log(x) * (1/ln 10), the form jnp.log10 has
INV_LN10 = 0.4342944920063019


def _log10(x):
    """log10 clamped at 1e-9.  A Python float becomes a 0-dim float32 CPU
    tensor, so the scalar terms of a formula round in float32 as JAX's
    weakly typed scalars do (and combine with tensors on any device)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.float32)
    return torch.log(torch.clamp(x, min=1e-9)) * INV_LN10


@dataclasses.dataclass(frozen=True)
class PathlossBase:
    """Common interface.  fc_GHz is carrier frequency in GHz."""

    fc_GHz: float = 3.5
    LOS: bool = False  # True -> line-of-sight formulas

    def get_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        raise NotImplementedError

    def get_pathgain(self, d2d, d3d, h_bs, h_ut):
        return db_to_gain(self.get_pathloss_dB(d2d, d3d, h_bs, h_ut))

    def __call__(self, d2d, d3d, h_bs, h_ut):
        return self.get_pathgain(d2d, d3d, h_bs, h_ut)


# ---------------------------------------------------------------------------
# RMa -- Rural Macrocell
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RMa_pathloss(PathlossBase):
    """TR 38.901 RMa.  Defaults: h_BS=35 m, h_UT=1.5 m, W=20 m, h=5 m."""

    W: float = 20.0  # average street width, m
    h: float = 5.0   # average building height, m

    def _d_bp(self, h_bs, h_ut):
        fc_hz = self.fc_GHz * 1e9
        return 2.0 * math.pi * h_bs * h_ut * fc_hz / C_LIGHT

    def _ab(self):
        return (min(0.03 * self.h ** 1.72, 10.0),
                min(0.044 * self.h ** 1.72, 14.77))

    def _pl1(self, d3d):
        # PL1, valid 10 m <= d2D <= d_BP
        a, b = self._ab()
        return (20.0 * _log10(40.0 * math.pi * d3d * self.fc_GHz / 3.0)
                + a * _log10(d3d) - b + 0.002 * _log10(self.h) * d3d)

    def los_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        d_bp = self._d_bp(h_bs, h_ut)
        pl1 = self._pl1(d3d)
        d_bp_t = torch.as_tensor(d_bp, dtype=d3d.dtype, device=d3d.device)
        pl2 = self._pl1(d_bp_t) + 40.0 * _log10(
            d3d / torch.clamp(d_bp_t, min=1.0))
        return torch.where(d2d <= d_bp_t, pl1, pl2)

    def nlos_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        W, h, fc = self.W, self.h, self.fc_GHz
        pl_nlos = (161.04 - 7.1 * _log10(W) + 7.5 * _log10(h)
                   - (24.37 - 3.7 * (h / h_bs) ** 2) * _log10(h_bs)
                   + (43.42 - 3.1 * _log10(h_bs)) * (_log10(d3d) - 3.0)
                   + 20.0 * _log10(fc)
                   - (3.2 * _log10(11.75 * h_ut) ** 2 - 4.97))
        return torch.maximum(self.los_pathloss_dB(d2d, d3d, h_bs, h_ut),
                             pl_nlos)

    def get_pathloss_dB(self, d2d, d3d, h_bs=35.0, h_ut=1.5):
        if self.LOS:
            return self.los_pathloss_dB(d2d, d3d, h_bs, h_ut)
        return self.nlos_pathloss_dB(d2d, d3d, h_bs, h_ut)

    def _kernel_pl1(self):
        """(C0, s1, lin): PL1(d) = C0 + s1 log2(d^2) + lin d in log2 gain."""
        a, b = self._ab()
        return (_l2g(20.0 * math.log10(40.0 * math.pi * self.fc_GHz / 3.0)
                     - b),
                _slope(20.0 + a), _l2g(0.002 * math.log10(self.h)))

    def _kernel_heights(self):
        """(fixed, h_bs, h_ut): heights the kernel reads instead of the
        positions' when ``fixed`` is 1."""
        return 0.0, 0.0, 0.0

    def kernel_spec(self):
        # kappa, C0, s1, lin, LOS, fixed, h_bs, h_ut, Kc, h (PL<F_RMA>)
        c0, s1, lin = self._kernel_pl1()
        kc = _l2g(161.04 - 7.1 * math.log10(self.W) + 7.5 * math.log10(self.h)
                  + 20.0 * math.log10(self.fc_GHz) + 4.97)
        kappa = 2.0 * math.pi * self.fc_GHz * 1e9 / C_LIGHT
        return PL_RMA, (kappa, c0, s1, lin, float(self.LOS),
                        *self._kernel_heights(), kc, float(self.h))


@dataclasses.dataclass(frozen=True)
class RMa_pathloss_constant_height(RMa_pathloss):
    """RMa with heights fixed at construction time."""

    h_bs: float = 35.0
    h_ut: float = 1.5

    def get_pathloss_dB(self, d2d, d3d, h_bs=None, h_ut=None):
        # heights are baked in; arguments accepted (and ignored)
        return super().get_pathloss_dB(d2d, d3d, self.h_bs, self.h_ut)

    def _kernel_heights(self):
        return 1.0, float(self.h_bs), float(self.h_ut)


class RMa_pathloss_discretised:
    """RMa via a pre-computed coefficient LUT over discrete UE heights.

    The LUTs are float32 tensors computed on the CPU at construction and
    copied once to each device a query runs on.
    """

    def __init__(self, fc_GHz=3.5, LOS=False, W=20.0, h=5.0, h_bs=35.0,
                 h_ut_min=1.0, h_ut_max=2.5, h_ut_step=0.25):
        self.fc_GHz, self.LOS = fc_GHz, LOS
        self.h_bs = h_bs
        self.full = RMa_pathloss(fc_GHz=fc_GHz, LOS=LOS, W=W, h=h)
        self.h_ut_min = h_ut_min
        self.h_ut_step = h_ut_step
        hs = torch.tensor(np.arange(h_ut_min, h_ut_max + 1e-9, h_ut_step),
                          dtype=torch.float32)
        self.h_grid = hs
        # NLOS affine coefficients per height bin: PL_nlos = A + B*log10(d3d)
        B = 43.42 - 3.1 * _log10(h_bs)
        A = (161.04 - 7.1 * _log10(W) + 7.5 * _log10(h)
             - (24.37 - 3.7 * (h / h_bs) ** 2) * _log10(h_bs)
             - 3.0 * B
             + 20.0 * _log10(fc_GHz)
             - (3.2 * _log10(11.75 * hs) ** 2 - 4.97))
        self.A_lut = A                       # (H,)
        self.B = float(B)                    # scalar
        self.d_bp_lut = self.full._d_bp(h_bs, hs)            # (H,)
        self.pl1_at_bp_lut = self.full._pl1(self.d_bp_lut)   # (H,)
        self._on_device = {}

    def _luts(self, device):
        if device not in self._on_device:
            self._on_device[device] = tuple(
                t.to(device) for t in (self.A_lut, self.d_bp_lut,
                                       self.pl1_at_bp_lut))
        return self._on_device[device]

    def _bin(self, h_ut):
        idx = torch.round((h_ut - self.h_ut_min) / self.h_ut_step).to(
            torch.int64)
        return torch.clamp(idx, 0, self.h_grid.shape[0] - 1)

    def get_pathloss_dB(self, d2d, d3d, h_bs=None, h_ut=1.5):
        h_ut = torch.as_tensor(h_ut, dtype=d3d.dtype, device=d3d.device)
        A_lut, d_bp_lut, pl1_lut = self._luts(d3d.device)
        k = self._bin(h_ut)
        d_bp = d_bp_lut[k]
        pl1 = self.full._pl1(d3d)
        pl2 = pl1_lut[k] + 40.0 * _log10(d3d / torch.clamp(d_bp, min=1.0))
        pl_los = torch.where(d2d <= d_bp, pl1, pl2)
        if self.LOS:
            return pl_los
        pl_nlos = A_lut[k] + self.B * _log10(d3d)
        return torch.maximum(pl_los, pl_nlos)

    def get_pathgain(self, d2d, d3d, h_bs=None, h_ut=1.5):
        return db_to_gain(self.get_pathloss_dB(d2d, d3d, h_bs, h_ut))

    def __call__(self, d2d, d3d, h_bs=None, h_ut=1.5):
        return self.get_pathgain(d2d, d3d, h_bs, h_ut)

    def kernel_spec(self):
        # C0, s1, lin, LOS, h_min, h_step, sn, H, then (d_bp, c2, cn) per
        # height bin (PL<F_RMA_DISC>)
        c0, s1, lin = self.full._kernel_pl1()
        bins = []
        for d_bp, pl1_bp, a in zip(self.d_bp_lut.tolist(),
                                   self.pl1_at_bp_lut.tolist(),
                                   self.A_lut.tolist()):
            bins += [d_bp, _l2g(pl1_bp - 40.0 * math.log10(max(d_bp, 1.0))),
                     _l2g(a)]
        return PL_RMA_DISCRETISED, (
            (c0, s1, lin, float(self.LOS), float(self.h_ut_min),
             float(self.h_ut_step), _slope(self.B),
             float(self.h_grid.shape[0])) + tuple(bins))


# ---------------------------------------------------------------------------
# UMa -- Urban Macrocell (h_BS = 25 m)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class UMa_pathloss(PathlossBase):
    def _d_bp_eff(self, h_bs, h_ut):
        # effective environment height h_E = 1 m (h_UT < 13 m case)
        h_e = 1.0
        fc_hz = self.fc_GHz * 1e9
        return 4.0 * (h_bs - h_e) * (h_ut - h_e) * fc_hz / C_LIGHT

    def los_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        fc = self.fc_GHz
        d_bp = self._d_bp_eff(h_bs, h_ut)
        pl1 = 28.0 + 22.0 * _log10(d3d) + 20.0 * _log10(fc)
        pl2 = (28.0 + 40.0 * _log10(d3d) + 20.0 * _log10(fc)
               - 9.0 * _log10(d_bp ** 2 + (h_bs - h_ut) ** 2))
        return torch.where(d2d <= d_bp, pl1, pl2)

    def nlos_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        fc = self.fc_GHz
        pl_nlos = (13.54 + 39.08 * _log10(d3d) + 20.0 * _log10(fc)
                   - 0.6 * (h_ut - 1.5))
        return torch.maximum(self.los_pathloss_dB(d2d, d3d, h_bs, h_ut),
                             pl_nlos)

    def get_pathloss_dB(self, d2d, d3d, h_bs=25.0, h_ut=1.5):
        if self.LOS:
            return self.los_pathloss_dB(d2d, d3d, h_bs, h_ut)
        return self.nlos_pathloss_dB(d2d, d3d, h_bs, h_ut)

    def kernel_spec(self):
        # kappa, c1, s1, c2, s2, t2, LOS, cn, sn, hn (PL<F_UM>)
        lfc = math.log10(self.fc_GHz)
        c1 = _l2g(28.0 + 20.0 * lfc)
        return PL_UMA, (4.0 * self.fc_GHz * 1e9 / C_LIGHT, c1, _slope(22.0),
                        c1, _slope(40.0), 0.9, float(self.LOS),
                        _l2g(13.54 + 0.6 * 1.5 + 20.0 * lfc), _slope(39.08),
                        0.6 * LOG2_GAIN_PER_DB)


# ---------------------------------------------------------------------------
# UMi -- Urban Microcell, street canyon (h_BS = 10 m)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class UMi_pathloss(PathlossBase):
    def _d_bp_eff(self, h_bs, h_ut):
        h_e = 1.0
        fc_hz = self.fc_GHz * 1e9
        return 4.0 * (h_bs - h_e) * (h_ut - h_e) * fc_hz / C_LIGHT

    def los_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        fc = self.fc_GHz
        d_bp = self._d_bp_eff(h_bs, h_ut)
        pl1 = 32.4 + 21.0 * _log10(d3d) + 20.0 * _log10(fc)
        pl2 = (32.4 + 40.0 * _log10(d3d) + 20.0 * _log10(fc)
               - 9.5 * _log10(d_bp ** 2 + (h_bs - h_ut) ** 2))
        return torch.where(d2d <= d_bp, pl1, pl2)

    def nlos_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        fc = self.fc_GHz
        pl_nlos = (35.3 * _log10(d3d) + 22.4 + 21.3 * _log10(fc)
                   - 0.3 * (h_ut - 1.5))
        return torch.maximum(self.los_pathloss_dB(d2d, d3d, h_bs, h_ut),
                             pl_nlos)

    def get_pathloss_dB(self, d2d, d3d, h_bs=10.0, h_ut=1.5):
        if self.LOS:
            return self.los_pathloss_dB(d2d, d3d, h_bs, h_ut)
        return self.nlos_pathloss_dB(d2d, d3d, h_bs, h_ut)

    def kernel_spec(self):
        # kappa, c1, s1, c2, s2, t2, LOS, cn, sn, hn (PL<F_UM>)
        lfc = math.log10(self.fc_GHz)
        c1 = _l2g(32.4 + 20.0 * lfc)
        return PL_UMI, (4.0 * self.fc_GHz * 1e9 / C_LIGHT, c1, _slope(21.0),
                        c1, _slope(40.0), 0.95, float(self.LOS),
                        _l2g(22.4 + 0.3 * 1.5 + 21.3 * lfc), _slope(35.3),
                        0.3 * LOG2_GAIN_PER_DB)


# ---------------------------------------------------------------------------
# InH -- Indoor Hotspot (office)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InH_pathloss(PathlossBase):
    def los_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        return 32.4 + 17.3 * _log10(d3d) + 20.0 * _log10(self.fc_GHz)

    def nlos_pathloss_dB(self, d2d, d3d, h_bs, h_ut):
        pl_nlos = 38.3 * _log10(d3d) + 17.30 + 24.9 * _log10(self.fc_GHz)
        return torch.maximum(self.los_pathloss_dB(d2d, d3d, h_bs, h_ut),
                             pl_nlos)

    def get_pathloss_dB(self, d2d, d3d, h_bs=3.0, h_ut=1.0):
        if self.LOS:
            return self.los_pathloss_dB(d2d, d3d, h_bs, h_ut)
        return self.nlos_pathloss_dB(d2d, d3d, h_bs, h_ut)

    def kernel_spec(self):
        # c1, s1, LOS, cn, sn (PL<F_INH>)
        lfc = math.log10(self.fc_GHz)
        return PL_INH, (_l2g(32.4 + 20.0 * lfc), _slope(17.3),
                        float(self.LOS), _l2g(17.30 + 24.9 * lfc),
                        _slope(38.3))


# ---------------------------------------------------------------------------
# Power-law -- g(d) = (d/d0)^(-alpha)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PowerLaw_pathloss(PathlossBase):
    alpha: float = 3.5
    d0: float = 1.0  # reference distance, m

    def get_pathloss_dB(self, d2d, d3d, h_bs=None, h_ut=None):
        return 10.0 * self.alpha * _log10(d3d / self.d0)

    def get_pathgain(self, d2d, d3d, h_bs=None, h_ut=None):
        # exact power law, avoids the dB round-trip
        return torch.pow(torch.clamp(d3d / self.d0, min=1e-9), -self.alpha)

    def kernel_spec(self):
        # -alpha / 2, 1 / d0^2 (PL<F_POW>)
        return PL_POWER_LAW, (-0.5 * self.alpha, 1.0 / self.d0 ** 2)


PATHLOSS_MODELS = {
    "RMa": RMa_pathloss,
    "RMa_constant_height": RMa_pathloss_constant_height,
    "RMa_discretised": RMa_pathloss_discretised,
    "UMa": UMa_pathloss,
    "UMi": UMi_pathloss,
    "InH": InH_pathloss,
    "power_law": PowerLaw_pathloss,
}


def make_pathloss(name: str, **kwargs):
    """Strategy-pattern factory: model name -> model instance."""
    try:
        cls = PATHLOSS_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown pathloss model {name!r}; have {sorted(PATHLOSS_MODELS)}")
    return cls(**kwargs)
