"""CRRM -- the main simulator class (the paper's public API), in PyTorch.

Wires the Figure-1 dependency graph, binds the pluggable pathloss strategy,
and exposes the mutation / query API.  Queries trigger the recursive update
phase; mutations trigger the invalidation phase only.

>>> from repro_torch.core.params import CRRM_parameters
>>> from repro_torch.core.crrm import CRRM
>>> sim = CRRM(CRRM_parameters(n_ues=50, pathloss_model_name="UMa", seed=1),
...            device="cpu")
>>> tput = sim.get_UE_throughputs()          # full evaluation
>>> sim.move_UE(3, (100.0, 200.0, 1.5))      # invalidates row 3 only
>>> tput2 = sim.get_UE_throughputs()         # row-local smart update

``device=None`` means the CUDA device; without one the constructor raises
unless the caller passes ``device="cpu"``.  The initial UE drop and fading
draw come from ``torch.Generator(device).manual_seed(params.seed)``: they
are not the JAX package's numbers for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import blocks
from repro_torch.core.graph import Graph, RootNode
from repro_torch.core.params import CRRM_parameters
from repro_torch.mac import traffic
from repro_torch.sim import deploy, radio
from repro_torch.sim.antenna import Antenna_gain, sector_boresights
from repro_torch.sim.pathloss import make_pathloss


class CRRM:
    def __init__(self, params: CRRM_parameters, device=None):
        self.params = params
        self.device = dev = resolve_device(device)
        p = params
        gen = torch.Generator(device=dev)
        gen.manual_seed(p.seed)
        f32 = torch.float32

        # -- topology roots -------------------------------------------------
        if p.ue_positions is not None:
            U0 = torch.tensor(np.asarray(p.ue_positions), dtype=f32,
                              device=dev)
        else:
            U0 = deploy.ppp_points(gen, p.n_ues, p.extent_m, z=p.h_ut_m)
        if p.cell_positions is not None:
            C0 = torch.tensor(np.asarray(p.cell_positions), dtype=f32,
                              device=dev)
        else:
            n_cells = p.n_cells or 7
            n_sites = max(1, n_cells // p.n_sectors)
            rings = 0
            while 1 + 3 * rings * (rings + 1) < n_sites:
                rings += 1
            sites = deploy.hex_sites(rings, isd_m=p.extent_m / (2 * rings + 1)
                                     if rings else p.extent_m, z=p.h_bs_m,
                                     device=dev)
            sites = sites[:n_sites] + torch.tensor(
                [p.extent_m / 2, p.extent_m / 2, 0.0], dtype=f32, device=dev)
            C0 = deploy.replicate_sectors(sites, p.n_sectors)
        self.n_cells = int(C0.shape[0])
        self.n_ues = int(U0.shape[0])

        self.n_freq = p.n_freq
        if p.power_matrix is not None:
            P0 = torch.tensor(np.asarray(p.power_matrix), dtype=f32,
                              device=dev)
            if p.n_rb_subbands > 1:     # split each subband's power evenly
                P0 = torch.repeat_interleave(
                    P0, p.n_rb_subbands, dim=1) / p.n_rb_subbands
        else:
            P0 = torch.full((self.n_cells, self.n_freq),
                            p.power_W / self.n_freq, dtype=f32, device=dev)

        bore0 = sector_boresights(self.n_cells // p.n_sectors, p.n_sectors,
                                  device=dev)

        self.pathloss_model = make_pathloss(p.pathloss_model_name,
                                            **p.pathloss_params)
        #: the model object itself is the pathgain callable (it also
        #: describes itself to the fused kernel)
        self.pathgain_function = self.pathloss_model
        antenna = Antenna_gain(phi_3dB_deg=p.antenna_phi_3dB_deg,
                               A_max_dB=p.antenna_A_max_dB)
        self.antenna = antenna
        self._radio_cfg = radio.config_from_params(
            p, self.pathgain_function, antenna)

        if p.rayleigh_fading:
            F0 = radio.draw_fading(self._radio_cfg, gen, self.n_ues,
                                   self.n_cells)
        else:
            F0 = radio.unit_fading(self._radio_cfg, self.n_ues, self.n_cells,
                                   device=dev)

        # -- graph ------------------------------------------------------------
        g = Graph(smart=p.smart)
        self.graph = g
        self.U = g.add(RootNode("U", U0))
        self.C = g.add(RootNode("C", C0))
        self.P = g.add(RootNode("P", P0))
        self.boresight = g.add(RootNode("boresight", bore0))
        self.fading = g.add(RootNode("fading", F0))

        self.D = g.add(blocks.DistanceNode(self.U, self.C))
        self.G = g.add(blocks.GainNode(
            self.D, self.U, self.C, self.boresight, self.fading,
            self.pathgain_function, antenna, p.n_sectors))
        self.R = g.add(blocks.RSRPNode(self.G, self.P))
        if p.rayleigh_fading and p.attach_ignores_fading:
            # association on the long-term mean: a parallel unfaded branch
            self.ones = g.add(RootNode(
                "ones", torch.ones((self.n_ues, self.n_cells), device=dev)))
            self.G_mean = g.add(blocks.GainNode(
                self.D, self.U, self.C, self.boresight, self.ones,
                self.pathgain_function, antenna, p.n_sectors, name="G_mean"))
            self.R_mean = g.add(blocks.RSRPNode(self.G_mean, self.P,
                                                name="RSRP_mean"))
            self.a = g.add(blocks.AttachmentNode(self.R_mean))
        else:
            self.a = g.add(blocks.AttachmentNode(self.R))
        self.w = g.add(blocks.WantedNode(self.R, self.a))
        self.u = g.add(blocks.InterferenceNode(self.R, self.w))
        self.gamma = g.add(blocks.SINRNode(self.w, self.u, p.chunk_noise_W))
        self.cqi = g.add(blocks.CQINode(
            self.gamma, p.n_rb_subbands, p.cqi_report == "wideband",
            p.cqi_eesm_beta))
        self.mcs = g.add(blocks.MCSNode(self.cqi))
        self.se = g.add(blocks.SpectralEfficiencyNode(self.mcs, self.cqi))
        self.shannon = g.add(blocks.ShannonNode(
            self.gamma, p.chunk_bandwidth_Hz, p.n_tx, p.n_rx))
        self.throughput = g.add(blocks.ThroughputNode(
            self.se, self.a, self.n_cells, p.chunk_bandwidth_Hz,
            p.fairness_p))

        # -- MAC subsystem: traffic -> buffers -> scheduler -> served -------
        init_backlog, self._traffic_step = traffic.make_traffic(
            p.traffic_model, self.n_ues, p.tti_s, device=dev,
            **p.traffic_params)
        self.buffer = g.add(blocks.BufferNode(init_backlog()))
        self.sched = g.add(blocks.ScheduleNode(
            self.se, self.cqi, self.a, self.buffer, self.n_cells,
            p.rb_per_chunk, p.scheduler_policy, p.fairness_p))
        self.served = g.add(blocks.ServedThroughputNode(
            self.sched, self.se, self.buffer,
            p.subband_bandwidth_Hz / p.n_rb, p.tti_s))

    def _tensor(self, x, dtype=torch.float32):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- mutations
    def move_UE(self, i: int, xyz) -> None:
        self.U.set_rows(np.asarray([i]), np.asarray(xyz, np.float32)[None, :])

    def move_UEs(self, idx, xyz) -> None:
        self.U.set_rows(np.asarray(idx), np.asarray(xyz, np.float32))

    def set_UE_positions(self, U) -> None:
        self.U.set(self._tensor(U))

    def set_power_matrix(self, P) -> None:
        """Set per-cell/subband powers; accepts (n_cells, n_subbands)
        (expanded onto the n_freq grid) or (n_cells, n_freq)."""
        P = self._tensor(P)
        p = self.params
        if p.n_rb_subbands > 1 and P.shape[1] == p.n_subbands:
            P = torch.repeat_interleave(P, p.n_rb_subbands,
                                        dim=1) / p.n_rb_subbands
        if tuple(P.shape) != (self.n_cells, self.n_freq):
            raise ValueError(
                f"power matrix must be (n_cells, n_subbands)="
                f"({self.n_cells}, {p.n_subbands}) or (n_cells, n_freq)="
                f"({self.n_cells}, {self.n_freq}); got {tuple(P.shape)}")
        self.P.set(P)

    def set_cell_power(self, j: int, k: int, watts: float) -> None:
        """Set cell ``j``'s power on *subband* ``k`` (spread evenly over the
        subband's CQI chunks)."""
        s = self.params.n_rb_subbands
        self.P.set_at((j, slice(k * s, (k + 1) * s)), watts / s)

    def resample_fading(self, gen: torch.Generator) -> None:
        """Redraw the fast-fading root via ``radio.draw_fading`` on ``gen``."""
        self.fading.set(radio.draw_fading(self._radio_cfg, gen, self.n_ues,
                                          self.n_cells))

    def add_traffic(self, idx, bits) -> None:
        """Queue arrival bits onto selected UEs (row-local MAC flood)."""
        self.buffer.add_bits(idx, bits)

    def set_backlog(self, backlog) -> None:
        self.buffer.set(self._tensor(backlog))

    def step_traffic(self, gen: torch.Generator) -> None:
        """Draw one TTI of arrivals from the configured traffic model."""
        if self._traffic_step is not None:
            self.buffer.set(self.buffer._data + self._traffic_step(gen))

    # ------------------------------------------------------------------- queries
    def get_distances(self):
        return self.D.update()

    def get_pathgains(self):
        return self.G.update()

    def get_RSRP(self):
        return self.R.update()

    def get_attachment(self):
        return self.a.update()

    def get_SINR(self):
        """(n_ue, n_freq) linear SINR."""
        return self.gamma.update()

    def get_SINR_dB(self):
        return 10.0 * torch.log10(torch.clamp(self.get_SINR(), min=1e-12))

    def get_CQI(self):
        return self.cqi.update()

    def get_MCS(self):
        return self.mcs.update()

    def get_spectral_efficiency(self):
        return self.se.update()

    def get_shannon_capacities(self):
        """(n_ue, n_freq) bits/s upper bound."""
        return self.shannon.update()

    def get_UE_throughputs(self):
        """(n_ue,) bits/s: fairness-weighted share summed over subbands."""
        return self.throughput.update().sum(dim=1)

    def get_backlog(self):
        """(n_ue,) bits queued (inf for full-buffer traffic)."""
        return self.buffer.update()

    def get_schedule(self):
        """(n_ue, n_freq) resource blocks granted this TTI."""
        return self.sched.update()

    def get_served_throughputs(self):
        """(n_ue,) bits/s through the MAC chain (grant capped by backlog)."""
        return self.served.update().sum(dim=1)

    # ---------------------------------------------------------------- pure radio
    def radio_config(self) -> "radio.RadioConfig":
        return self._radio_cfg

    def radio_static(self) -> "radio.RadioStatic":
        """The :class:`~repro_torch.sim.radio.RadioStatic` of the current
        graph roots, for ``radio.radio_forward``."""
        return radio.RadioStatic(C=self.C._data, P=self.P._data,
                                 bore=self.boresight._data,
                                 cfg=self._radio_cfg)

    # ------------------------------------------------------------------ episodes
    def init_episode_state(self, seed=None):
        """The episode carry as an explicit ``EpisodeState``: buffers, PF
        EWMA (seeded from the single-shot served throughput), round-robin
        cursor, HARQ processes, serving cells / TTT counters, positions --
        or what a previous ``sync_episode_state`` left on the simulator --
        and the episode seed as the int64 ``seed`` leaf (``None`` means
        ``params.seed``), the counterpart of the reference's ``key=``.

        ``U`` and ``backlog`` are the graph's own tensors: a caller that
        writes into the state in place clones them first."""
        from repro_torch.mac.engine import EpisodeState
        n, dev, i32 = self.n_ues, self.device, torch.int32
        if seed is None:
            seed = self.params.seed
        avg0 = getattr(self, "_pf_avg", None)
        if avg0 is None:
            avg0 = self.get_served_throughputs().clone()
        hbits0 = getattr(self, "_harq_bits", None)
        if hbits0 is None:
            hbits0 = torch.zeros((n,), dtype=torch.float32, device=dev)
        hretx0 = getattr(self, "_harq_retx", None)
        if hretx0 is None:
            hretx0 = torch.zeros((n,), dtype=i32, device=dev)
        a0 = getattr(self, "_ho_serving", None)
        if a0 is None:
            a0 = self.get_attachment().clone()
        ttt0 = getattr(self, "_ho_ttt", None)
        if ttt0 is None:
            ttt0 = torch.zeros((n,), dtype=i32, device=dev)
        return EpisodeState(
            U=self.U._data, backlog=self.buffer._data, pf_avg=avg0,
            rr_cursor=torch.tensor(self.sched.cursor, dtype=i32, device=dev),
            harq_bits=hbits0, harq_retx=hretx0.to(i32),
            serving=a0.to(i32), ttt=ttt0.to(i32),
            t=torch.tensor(0, dtype=i32, device=dev),
            seed=torch.tensor(int(seed), dtype=torch.int64, device=dev))

    def episode_static(self):
        """The per-episode radio inputs (``EpisodeStatic``) off the graph."""
        from repro_torch.mac.engine import EpisodeStatic
        return EpisodeStatic(
            se=self.get_spectral_efficiency().clone(),
            cqi=self.get_CQI().clone(), a=self.get_attachment().clone(),
            C=self.C._data, P=self.P._data, bore=self.boresight._data,
            fad=self.fading._data)

    def episode_fns(self, mobility_step_m=None, per_tti_fading: bool = False,
                    use_harq=None, mesh=None, ue_axis=("ue",),
                    cell_axis=None, radio_mode=None, mobility_move_frac=None,
                    inc_backend=None, telemetry: bool = False, churn=None,
                    relax=None, faults=None):
        """The ``(step, rollout)`` episode functions for this simulator,
        cached per switch combination (see ``mac.engine.make_episode_fns``).
        ``mesh`` (a ``core.distributed.Mesh``) shards the UE axis over the
        ``ue_axis`` mesh axes, and ``cell_axis`` the cells too (a UE x
        cell mesh); each rank passes the global tensors and gets global
        ones back.  ``telemetry`` adds a per-TTI KPI tuple to both
        functions' returns; ``churn`` a ``sim.mobility.ChurnConfig`` turns
        on the birth-death UE process; ``relax`` a ``sim.radio.RelaxConfig``
        the differentiable chain (dense radio only); ``faults`` (default
        ``params.faults``, ``0`` forces it off) the per-cell fault
        process."""
        from repro_torch.mac import engine as mac_engine
        return mac_engine.episode_fns_for(
            self, mobility_step_m=mobility_step_m,
            per_tti_fading=per_tti_fading, use_harq=use_harq, mesh=mesh,
            ue_axis=ue_axis, cell_axis=cell_axis, radio_mode=radio_mode,
            mobility_move_frac=mobility_move_frac, inc_backend=inc_backend,
            telemetry=telemetry, churn=churn, relax=relax, faults=faults)

    def sync_episode_state(self, state, positions: bool = False) -> None:
        """Write a final ``EpisodeState`` back into the graph."""
        if positions:
            self.set_UE_positions(state.U)
        self.buffer.set(state.backlog)
        self._pf_avg = state.pf_avg
        self.sched.cursor = int(state.rr_cursor)
        self._harq_bits, self._harq_retx = state.harq_bits, state.harq_retx
        if self.params.ho_enabled:
            self._ho_serving, self._ho_ttt = state.serving, state.ttt

    def reset_episode_state(self) -> None:
        """Drop persisted episode state so the next ``init_episode_state``
        re-seeds from the graph."""
        for attr in ("_pf_avg", "_harq_bits", "_harq_retx",
                     "_ho_serving", "_ho_ttt"):
            if hasattr(self, attr):
                delattr(self, attr)

    def run_episode(self, n_tti: int, draws=None, mobility_step_m=None,
                    per_tti_fading: bool = False, sync_state: bool = True,
                    use_harq=None, mesh=None, radio_mode=None,
                    mobility_move_frac=None, inc_backend=None,
                    telemetry: bool = False, churn=None, faults=None):
        """Roll ``n_tti`` TTIs; returns (n_tti, n_ues) delivered bits/s, or
        ``(tput, telem)`` with ``telemetry=True``."""
        from repro_torch.mac import engine as mac_engine
        return mac_engine.run_episode(
            self, n_tti, draws=draws, mobility_step_m=mobility_step_m,
            per_tti_fading=per_tti_fading, sync_state=sync_state,
            use_harq=use_harq, mesh=mesh, radio_mode=radio_mode,
            mobility_move_frac=mobility_move_frac, inc_backend=inc_backend,
            telemetry=telemetry, churn=churn, faults=faults)

    # -------------------------------------------------------------- introspection
    def update_counts(self):
        return self.graph.stats()
