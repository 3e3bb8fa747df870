"""CRRM_parameters -- the single configuration object for a simulation.

A copy of ``repro.core.params``: the same fields, defaults, validation and
derived properties.  ``faults`` takes a ``sim.faults.FaultConfig``,
validated as in the reference; the episode engine runs it by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .faults import FaultConfig

BOLTZMANN = 1.380649e-23
T0_KELVIN = 290.0

SCHEDULER_POLICIES = ("rr", "max_cqi", "pf")
TRAFFIC_MODELS = ("full_buffer", "poisson", "ftp3")


def thermal_noise_W(bandwidth_hz: float, noise_figure_dB: float = 9.0) -> float:
    """kTB thermal noise power + UE noise figure, in watts."""
    return BOLTZMANN * T0_KELVIN * bandwidth_hz * 10 ** (noise_figure_dB / 10)


@dataclasses.dataclass
class CRRM_parameters:
    # topology -----------------------------------------------------------------
    n_ues: int = 100
    n_cells: Optional[int] = None          # derived from cell_positions if None
    ue_positions: Optional[Any] = None     # (n_ues, 3); random uniform if None
    cell_positions: Optional[Any] = None   # (n_cells, 3); hex grid if None
    extent_m: float = 3000.0               # square deployment region side
    h_ut_m: float = 1.5                    # default UE height
    h_bs_m: float = 25.0                   # default BS height (z of generated cells)

    # radio ----------------------------------------------------------------------
    pathloss_model_name: str = "UMa"       # key into sim.pathloss.PATHLOSS_MODELS
    pathloss_params: dict = dataclasses.field(default_factory=dict)
    fc_GHz: float = 3.5
    bandwidth_Hz: float = 20e6
    n_subbands: int = 1
    power_W: float = 1.0                   # per-cell tx power if power_matrix None
    power_matrix: Optional[Any] = None     # (n_cells, n_subbands) watts
    noise_power_W: Optional[float] = None  # sigma^2 over full band; kTB if None
    rayleigh_fading: bool = False
    #: associate on long-term (unfaded) RSRP
    attach_ignores_fading: bool = True

    # antennas ---------------------------------------------------------------------
    n_sectors: int = 1                     # 1 = omni, 3 = 3GPP tri-sector
    antenna_phi_3dB_deg: float = 65.0
    antenna_A_max_dB: float = 30.0

    # MAC / scheduling ----------------------------------------------------------------
    fairness_p: float = 0.0                # T_i = a * S_i^(1-p)
    n_tx: int = 1
    n_rx: int = 1
    traffic_model: str = "full_buffer"     # "full_buffer" | "poisson" | "ftp3"
    traffic_params: dict = dataclasses.field(default_factory=dict)
    scheduler_policy: str = "pf"           # "pf" | "rr" | "max_cqi"
    n_rb: int = 12                         # resource blocks per subband per TTI
    tti_s: float = 1e-3                    # TTI duration
    pf_ewma: float = 0.05                  # EWMA step of the PF average-rate state
    #: CQI-reporting subbands per subband (must divide ``n_rb``)
    n_rb_subbands: int = 1
    #: coherence bandwidth of the block-fading channel, in RBs
    coherence_rb: int = 4
    #: "subband" | "wideband" (EESM-pooled per power subband)
    cqi_report: str = "subband"
    cqi_eesm_beta: float = 1.0
    #: P(transport block lost) on the first HARQ attempt (0 = no HARQ)
    harq_bler: float = 0.0
    harq_max_retx: int = 3
    harq_comb_gain_db: float = 3.0
    #: per-TTI random-walk step bound in metres (None/0 = static geometry)
    mobility_step_m: Optional[float] = None
    #: fraction of UEs taking a step each TTI (None/1.0 = every UE)
    mobility_move_frac: Optional[float] = None
    #: "dense" | "incremental" radio chain inside the episode engine
    radio_mode: str = "dense"
    #: cell fault process (a ``sim.faults.FaultConfig``) the episode
    #: engine runs by default; None = no faults
    faults: Optional[Any] = None
    ho_enabled: bool = False
    ho_hysteresis_db: float = 3.0          # A3 entry margin over serving RSRP
    ho_ttt_tti: int = 4                    # time-to-trigger, in TTIs

    # engine -------------------------------------------------------------------------
    smart: bool = True                     # the compute-on-demand switch
    max_moves: Optional[int] = None        # cap on dirty-row bucket (None = n_ues)
    seed: int = 0
    dtype: Any = np.float32

    def __post_init__(self):
        if self.n_subbands < 1:
            raise ValueError("n_subbands must be >= 1")
        if not 0.0 <= self.fairness_p <= 1.0:
            raise ValueError("fairness_p must be in [0, 1]")
        if self.traffic_model not in TRAFFIC_MODELS:
            raise ValueError(f"traffic_model must be one of {TRAFFIC_MODELS}")
        if self.scheduler_policy not in SCHEDULER_POLICIES:
            raise ValueError(
                f"scheduler_policy must be one of {SCHEDULER_POLICIES}")
        if self.n_rb < 1:
            raise ValueError("n_rb must be >= 1")
        if not 0.0 < self.pf_ewma <= 1.0:
            raise ValueError("pf_ewma must be in (0, 1]")
        if not 0.0 <= self.harq_bler < 1.0:
            raise ValueError("harq_bler must be in [0, 1)")
        if self.n_rb_subbands < 1 or self.n_rb % self.n_rb_subbands:
            raise ValueError(
                f"n_rb_subbands must be a positive divisor of n_rb="
                f"{self.n_rb}; got {self.n_rb_subbands}")
        if self.coherence_rb < 1:
            raise ValueError("coherence_rb must be >= 1")
        if self.cqi_report not in ("subband", "wideband"):
            raise ValueError(
                f"cqi_report must be 'subband' or 'wideband'; "
                f"got {self.cqi_report!r}")
        if self.cqi_eesm_beta <= 0.0:
            raise ValueError("cqi_eesm_beta must be > 0")
        if self.harq_max_retx < 0:
            raise ValueError("harq_max_retx must be >= 0")
        if self.harq_comb_gain_db < 0.0:
            raise ValueError("harq_comb_gain_db must be >= 0")
        if self.mobility_step_m is not None and self.mobility_step_m < 0.0:
            raise ValueError("mobility_step_m must be >= 0 (or None)")
        if self.mobility_move_frac is not None and not (
                0.0 < self.mobility_move_frac <= 1.0):
            raise ValueError("mobility_move_frac must be in (0, 1] (or None)")
        if self.radio_mode not in ("dense", "incremental"):
            raise ValueError(
                f"radio_mode must be 'dense' or 'incremental'; "
                f"got {self.radio_mode!r}")
        if self.faults is not None:
            if not isinstance(self.faults, FaultConfig):
                raise ValueError(
                    f"faults must be a sim.faults.FaultConfig (or None); "
                    f"got {type(self.faults).__name__}")
            f = self.faults
            if f.outage_rate_hz < 0.0 or f.sleep_rate_hz < 0.0:
                raise ValueError("fault rates must be >= 0")
            if f.mean_outage_s <= 0.0 or f.mean_sleep_s <= 0.0:
                raise ValueError("fault dwell means must be > 0")
            for p in (f.outage_rate_hz * self.tti_s,
                      f.sleep_rate_hz * self.tti_s,
                      self.tti_s / f.mean_outage_s,
                      self.tti_s / f.mean_sleep_s):
                if p > 1.0:
                    raise ValueError(
                        "fault transition probability exceeds 1 per TTI: "
                        "lower the rate or raise the dwell mean "
                        f"(tti_s={self.tti_s})")
        if self.ho_hysteresis_db < 0.0:
            raise ValueError("ho_hysteresis_db must be >= 0")
        if self.ho_ttt_tti < 1:
            raise ValueError("ho_ttt_tti must be >= 1")
        if self.power_matrix is not None:
            pm = np.asarray(self.power_matrix)
            if pm.ndim != 2 or pm.shape[1] != self.n_subbands:
                raise ValueError(
                    f"power_matrix must be (n_cells, n_subbands); got {pm.shape}")
            if self.n_cells is None:
                self.n_cells = pm.shape[0]
        if self.cell_positions is not None:
            cp = np.asarray(self.cell_positions)
            if self.n_cells is None:
                self.n_cells = cp.shape[0]
            elif self.n_cells != cp.shape[0]:
                raise ValueError("n_cells inconsistent with cell_positions")
        if self.noise_power_W is None:
            self.noise_power_W = thermal_noise_W(self.bandwidth_Hz)

    @property
    def subband_bandwidth_Hz(self) -> float:
        return self.bandwidth_Hz / self.n_subbands

    @property
    def subband_noise_W(self) -> float:
        return self.noise_power_W / self.n_subbands

    @property
    def n_freq(self) -> int:
        """Scheduling-frequency chunks: subbands x CQI subbands per subband."""
        return self.n_subbands * self.n_rb_subbands

    @property
    def rb_per_chunk(self) -> int:
        """Resource blocks owned by one scheduling-frequency chunk."""
        return self.n_rb // self.n_rb_subbands

    @property
    def chunk_bandwidth_Hz(self) -> float:
        return self.bandwidth_Hz / self.n_freq

    @property
    def chunk_noise_W(self) -> float:
        return self.noise_power_W / self.n_freq
