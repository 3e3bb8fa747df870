"""Concrete CRRM computational blocks (the boxes of the paper's Figure 1).

Block list: U, C, P roots -> D -> G -> R(SRP) -> a -> w, u -> gamma (SINR)
-> CQI -> MCS -> SE -> Shannon, the fairness-share throughput terminal and
the MAC chain (buffer -> schedule -> served throughput).

The math of every radio block is ``repro_torch.sim.radio``; this module is
the smart-update shell: a full recompute and a row-local patch per node.
Row patches write into the node's own tensor in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import ALL, Node, RootNode
from repro_torch.mac import scheduler as mac_sched
from repro_torch.mac import segments
from repro_torch.sim import radio
from repro_torch.sim.antenna import Antenna_gain


class DistanceNode(Node):
    """D: 2-D/3-D distance matrices + bearing angles (one geometry pass)."""

    supports_row_update = True

    def __init__(self, U: RootNode, C: RootNode):
        super().__init__("D")
        self.watch(U, C)
        self.U, self.C = U, C

    def update_data(self):
        return radio.compute_distances(self.U._data, self.C._data)

    def update_rows(self, idx):
        rows = radio.compute_distances(self.U._data[idx], self.C._data)
        for full, r in zip(self._data, rows):
            full[idx] = r
        return self._data


class GainNode(Node):
    """G = pathgain(D) * antenna(az) * fading.

    The fading root is (n_ue, n_cell) for the flat channel or
    (n_ue, n_cell, n_freq) when frequency selective; G inherits its rank.
    """

    supports_row_update = True

    def __init__(self, D: DistanceNode, U: RootNode, C: RootNode,
                 boresight: RootNode, fading: RootNode,
                 pathgain_function, antenna: Antenna_gain, n_sectors: int,
                 name: str = "G"):
        super().__init__(name)
        self.watch(D, boresight, fading)
        self.D, self.U, self.C = D, U, C
        self.boresight, self.fading = boresight, fading
        self._gain = radio.make_gain_fn(pathgain_function, antenna, n_sectors)

    def update_data(self):
        d2d, d3d, az = self.D._data
        return self._gain(d2d, d3d, az, self.U._data[:, 2],
                          self.C._data[:, 2], self.boresight._data,
                          self.fading._data)

    def update_rows(self, idx):
        d2d, d3d, az = self.D._data
        self._data[idx] = self._gain(
            d2d[idx], d3d[idx], az[idx], self.U._data[idx, 2],
            self.C._data[:, 2], self.boresight._data, self.fading._data[idx])
        return self._data


class RSRPNode(Node):
    supports_row_update = True

    def __init__(self, G: GainNode, P: RootNode, name: str = "RSRP"):
        super().__init__(name)
        self.watch(G, P)
        self.G, self.P = G, P

    def update_data(self):
        return radio.rsrp(self.G._data, self.P._data)

    def update_rows(self, idx):
        self._data[idx] = radio.rsrp(self.G._data[idx], self.P._data)
        return self._data


class AttachmentNode(Node):
    """a: serving-cell index per UE (strongest wideband RSRP)."""

    supports_row_update = True

    def __init__(self, R: RSRPNode):
        super().__init__("a")
        self.watch(R)
        self.R = R

    def update_data(self):
        return radio.attachment(self.R._data)

    def update_rows(self, idx):
        self._data[idx] = radio.attachment(self.R._data[idx])
        return self._data


class WantedNode(Node):
    supports_row_update = True

    def __init__(self, R: RSRPNode, a: AttachmentNode):
        super().__init__("w")
        self.watch(R, a)
        self.R, self.a = R, a

    def update_data(self):
        return radio.wanted(self.R._data, self.a._data)

    def update_rows(self, idx):
        self._data[idx] = radio.wanted(self.R._data[idx], self.a._data[idx])
        return self._data


class InterferenceNode(Node):
    supports_row_update = True

    def __init__(self, R: RSRPNode, w: WantedNode):
        super().__init__("u")
        self.watch(R, w)
        self.R, self.w = R, w

    def update_data(self):
        return radio.interference(self.R._data, self.w._data)

    def update_rows(self, idx):
        self._data[idx] = radio.interference(self.R._data[idx],
                                             self.w._data[idx])
        return self._data


class SINRNode(Node):
    supports_row_update = True

    def __init__(self, w: WantedNode, u: InterferenceNode, noise_w: float):
        super().__init__("gamma")
        self.watch(w, u)
        self.w, self.u = w, u
        self.noise_w = noise_w

    def update_data(self):
        return radio.sinr_from_wu(self.w._data, self.u._data, self.noise_w)

    def update_rows(self, idx):
        self._data[idx] = radio.sinr_from_wu(self.w._data[idx],
                                             self.u._data[idx], self.noise_w)
        return self._data


class CQINode(Node):
    """CQI at the configured reporting resolution (``cqi_report`` knob)."""

    supports_row_update = True

    def __init__(self, gamma: SINRNode, n_rb_subbands: int = 1,
                 wideband: bool = False, eesm_beta: float = 1.0):
        super().__init__("CQI")
        self.watch(gamma)
        self.gamma = gamma
        self._report = (n_rb_subbands, wideband, eesm_beta)

    def update_data(self):
        return radio.cqi_report(self.gamma._data, *self._report)

    def update_rows(self, idx):
        self._data[idx] = radio.cqi_report(self.gamma._data[idx],
                                           *self._report)
        return self._data


class MCSNode(Node):
    supports_row_update = True

    def __init__(self, cqi: CQINode):
        super().__init__("MCS")
        self.watch(cqi)
        self.cqi = cqi

    def update_data(self):
        return radio.mcs_of(self.cqi._data)

    def update_rows(self, idx):
        self._data[idx] = radio.mcs_of(self.cqi._data[idx])
        return self._data


class SpectralEfficiencyNode(Node):
    supports_row_update = True

    def __init__(self, mcs: MCSNode, cqi: CQINode):
        super().__init__("SE")
        self.watch(mcs, cqi)
        self.mcs, self.cqi = mcs, cqi

    def update_data(self):
        return radio.se_of(self.mcs._data, self.cqi._data)

    def update_rows(self, idx):
        self._data[idx] = radio.se_of(self.mcs._data[idx],
                                      self.cqi._data[idx])
        return self._data


class ShannonNode(Node):
    """Information-theoretic capacity bound (incl. MIMO multiplexing)."""

    supports_row_update = True

    def __init__(self, gamma: SINRNode, subband_bw: float, n_tx: int,
                 n_rx: int):
        super().__init__("Shannon")
        self.watch(gamma)
        self.gamma = gamma
        self._scale = min(n_tx, n_rx) * subband_bw

    def _cap(self, gamma):
        return self._scale * torch.log2(1.0 + torch.clamp(gamma, min=0.0))

    def update_data(self):
        return self._cap(self.gamma._data)

    def update_rows(self, idx):
        self._data[idx] = self._cap(self.gamma._data[idx])
        return self._data


class ThroughputNode(Node):
    """Terminal block: fairness-weighted airtime share x MCS rate.

    Not row-local (a UE's move changes its cell's load), so it always
    recomputes in full: O(n_ue + n_cell) vector math.
    """

    supports_row_update = False

    def __init__(self, se: SpectralEfficiencyNode, a: AttachmentNode,
                 n_cells: int, subband_bw: float, p: float):
        super().__init__("T")
        self.watch(se, a)
        self.se, self.a = se, a
        self.n_cells, self.subband_bw, self.p = n_cells, subband_bw, p

    def propagate_rows(self, rows):
        return ALL  # cell loads mix rows

    def update_data(self):
        """T_i = a_cell * S_i^(1-p), a_cell = B_k / sum_j S_j^-p."""
        se, a = self.se._data, self.a._data
        active = se > 0.0
        wgt = torch.where(active,
                          torch.pow(torch.clamp(se, min=1e-12), -self.p), 0.0)
        denom_i = segments.segment_sum(wgt, a, self.n_cells)[a.long()]
        share = torch.where(denom_i > 0.0,
                            wgt / torch.clamp(denom_i, min=1e-30), 0.0)
        return share * self.subband_bw * se


class BufferNode(RootNode):
    """MAC backlog root: bits queued for each UE (``inf`` = full buffer)."""

    def __init__(self, backlog):
        super().__init__("buffer", backlog.to(torch.float32))

    def add_bits(self, idx, bits) -> None:
        """Accumulate arrival bits onto selected UEs (row-local flood).
        Duplicate indices accumulate (summed on the host first)."""
        idx = np.asarray(idx, dtype=np.int64)
        bits = np.broadcast_to(np.asarray(bits, dtype=np.float32), idx.shape)
        uniq, inv = np.unique(idx, return_inverse=True)
        acc = np.zeros(uniq.shape, np.float32)
        np.add.at(acc, inv, bits)
        dev = self._data.device
        new = self._data[torch.as_tensor(uniq, device=dev)] + torch.as_tensor(
            acc, device=dev)
        self.set_rows(uniq, new)


class ScheduleNode(Node):
    """alloc[i, k]: resource blocks granted to UE i on subband k (full
    recompute only: the grid split mixes rows within a cell)."""

    supports_row_update = False

    def __init__(self, se: SpectralEfficiencyNode, cqi: CQINode,
                 a: AttachmentNode, buffer: BufferNode, n_cells: int,
                 n_rb: int, policy: str, fairness_p: float):
        super().__init__("alloc")
        self.watch(se, cqi, a, buffer)
        self.se, self.cqi, self.a, self.buffer = se, cqi, a, buffer
        self.cursor = 0  # round-robin rotation state (engine rotates per TTI)
        self.n_cells, self.n_rb = n_cells, n_rb
        self.policy, self.fairness_p = policy, fairness_p

    def propagate_rows(self, rows):
        return ALL

    def update_data(self):
        se, backlog = self.se._data, self.buffer._data
        active = (backlog[:, None] > 0.0) & (se > 0.0)
        # the single-shot graph uses the stationary alpha-fair PF weights
        log_w = mac_sched.pf_log_weights_stationary(se, self.fairness_p)
        return mac_sched.allocate(self.policy, active, self.cqi._data,
                                  self.a._data, self.n_cells, self.n_rb,
                                  self.cursor, log_w)


class ServedThroughputNode(Node):
    """Terminal MAC block: served bits/s per (UE, subband), grant capacity
    capped by backlog."""

    supports_row_update = False

    def __init__(self, sched: ScheduleNode, se: SpectralEfficiencyNode,
                 buffer: BufferNode, rb_bw_hz: float, tti_s: float):
        super().__init__("T_served")
        self.watch(sched, se, buffer)
        self.sched, self.se, self.buffer = sched, se, buffer
        self.rb_bw_hz, self.tti_s = rb_bw_hz, tti_s

    def propagate_rows(self, rows):
        return ALL

    def update_data(self):
        bits = mac_sched.served_bits(self.sched._data, self.se._data,
                                     self.buffer._data, self.rb_bw_hz,
                                     self.tti_s)
        return bits / self.tti_s
