"""The plain reference of the CRRM cells: set-up and TTIs on one device.

A straightforward implementation of what the program's set-up and TTI
engine compute, written from the same equations: every TTI recomputes the
whole radio chain (distance, pathloss, sector pattern, fading, RSRP,
attachment, SINR, CQI, MCS, SE) from the current positions, with no
incremental state, no row index and no kernel, then runs the MAC (traffic,
proportional-fair grant, HARQ, A3 handover, churn, cell faults) and the
per-TTI telemetry.  The leaf modules beside this file are frozen copies of
the program's plain PyTorch physics; this module replaces its engine.

Randomness is worked out again from the seed: :class:`Draws` keys one
``torch.Generator`` per (lineage, stream, TTI) exactly as the program's
draws are specified, so the same seed gives the same inputs on both sides.

``dtype`` is the floating type of the positions and of the chain:
``torch.float32`` as the configuration states, or ``torch.bfloat16`` for
the control, which keeps the positions in it, casts the powers and fading
to it and computes the chain in it (the MAC's state stays float32).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import deploy, fading, mobility, phy, scheduler, telemetry
from . import faults as sim_faults
from .antenna import Antenna_gain, sector_boresights
from .params import CRRM_parameters
from .pathloss import make_pathloss
from .traffic import make_traffic

F32 = torch.float32
MOBILITY, FADING, TRAFFIC, HARQ = range(4)
BIRTH, DEATH, POSITION, CHURN_FADING = range(4)
_LEGACY, _CHURN, _FAULT, _RESET = range(4)
_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class Draws:
    """The per-TTI draws of an episode seed: one generator per (lineage,
    offset), keyed ``splitmix64(splitmix64(seed) + (lineage << 32 |
    offset))``; the legacy streams at offset ``4 t + stream``, churn at
    ``4 t + stream``, faults at ``t``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self._key = _splitmix64(int(seed) & _M64)

    def gen(self, lineage: int, offset: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_splitmix64((self._key + (lineage << 32 | offset))
                                  & _M64))
        return g

    def legacy(self, stream: int, t: int):
        return self.gen(_LEGACY, 4 * t + stream)

    def churn(self, stream: int, t: int):
        return self.gen(_CHURN, 4 * t + stream)


class Static(NamedTuple):
    C: Any
    P: Any
    bore: Any
    fad: Any


class Setup(NamedTuple):
    """What the reference derives from the configuration and the seed."""

    p: Any             # CRRM_parameters
    U: Any             # (n, 3) initial positions
    static: Static
    se: Any            # (n, K) initial spectral efficiency
    cqi: Any
    a: Any             # (n,) i32 initial attachment
    pf_avg: Any        # (n,) the stationary alpha-fair served throughput
    backlog: Any       # (n,) initial backlog
    n_cells: int


class Reference:
    """The reference for one configuration on one device."""

    def __init__(self, params: dict, device, dtype=F32, faults=None,
                 churn=None):
        extra = {} if faults is None else {"faults": faults}
        self.p = p = CRRM_parameters(**params, **extra)
        self.device = torch.device(device)
        self.dtype = dtype
        self.faults = faults
        self.churn = churn
        self.pathgain = make_pathloss(p.pathloss_model_name,
                                      **p.pathloss_params)
        self.antenna = Antenna_gain(phi_3dB_deg=p.antenna_phi_3dB_deg,
                                    A_max_dB=p.antenna_A_max_dB)
        self.noise_w = p.chunk_noise_W
        self.attach_on_mean = p.rayleigh_fading and p.attach_ignores_fading
        self.init_backlog, self.traffic_step = make_traffic(
            p.traffic_model, p.n_ues, p.tti_s, device=self.device,
            **p.traffic_params)

    # -- set-up ----------------------------------------------------------
    def setup(self) -> Setup:
        """The deployment, the fading draw and the initial chain and PF
        state, from ``params.seed`` alone."""
        p, dev = self.p, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(p.seed)
        U = deploy.ppp_points(gen, p.n_ues, p.extent_m, z=p.h_ut_m)
        U = U.to(self.dtype)
        n_cells = p.n_cells or 7
        n_sites = max(1, n_cells // p.n_sectors)
        rings = 0
        while 1 + 3 * rings * (rings + 1) < n_sites:
            rings += 1
        sites = deploy.hex_sites(rings, isd_m=p.extent_m / (2 * rings + 1)
                                 if rings else p.extent_m, z=p.h_bs_m,
                                 device=dev)
        sites = sites[:n_sites] + torch.tensor(
            [p.extent_m / 2, p.extent_m / 2, 0.0], dtype=F32, device=dev)
        C = deploy.replicate_sectors(sites, p.n_sectors)
        m = int(C.shape[0])
        P = torch.full((m, p.n_freq), p.power_W / p.n_freq, dtype=F32,
                       device=dev)
        bore = sector_boresights(m // p.n_sectors, p.n_sectors, device=dev)
        if p.rayleigh_fading:
            fad = self.draw_fading(gen, p.n_ues, m)
        else:
            fad = torch.ones((p.n_ues, m), dtype=F32, device=dev)
        static = Static(C=C, P=P, bore=bore, fad=fad)
        se, cqi, a, _ = self.chain(U, static, P, fad, None)
        backlog = self.init_backlog()
        pf0 = self.stationary_tput(se, cqi, a, backlog, m)
        return Setup(p=p, U=U, static=static, se=se, cqi=cqi, a=a,
                     pf_avg=pf0, backlog=backlog, n_cells=m)

    def draw_fading(self, gen, n_ues, n_cells):
        p = self.p
        if p.n_rb_subbands > 1:
            return fading.subband_rayleigh_power(
                gen, n_ues, n_cells, p.n_subbands * p.n_rb, p.coherence_rb,
                p.n_freq, F32)
        return fading.rayleigh_power(gen, (n_ues, n_cells), F32)

    def stationary_tput(self, se, cqi, a, backlog, n_cells):
        p = self.p
        active = (backlog[:, None] > 0.0) & (se > 0.0)
        log_w = scheduler.pf_log_weights_stationary(se, p.fairness_p)
        alloc = scheduler.allocate(p.scheduler_policy, active, cqi, a,
                                   n_cells, p.rb_per_chunk, 0, log_w)
        bits = scheduler.served_bits(alloc, se, backlog,
                                     p.subband_bandwidth_Hz / p.n_rb,
                                     p.tti_s)
        return (bits / p.tti_s).sum(dim=1)

    # -- the radio chain -------------------------------------------------
    def gains(self, U, static):
        """Unfaded linear gain (n, m) in the chain's dtype."""
        dt = self.dtype
        U, C = U.to(dt), static.C.to(dt)
        dx = U[:, None, 0] - C[None, :, 0]
        dy = U[:, None, 1] - C[None, :, 1]
        dz = U[:, None, 2] - C[None, :, 2]
        d2d = torch.sqrt(dx * dx + dy * dy)
        d3d = torch.sqrt(d2d * d2d + dz * dz)
        g = self.pathgain(d2d, d3d, C[:, 2][None, :], U[:, 2][:, None])
        if self.p.n_sectors > 1:
            az = torch.atan2(dy, dx)
            g = g * self.antenna.gain_linear(az, static.bore.to(dt))
        return g.to(dt)

    @staticmethod
    def faded(G0, fad):
        if fad.dim() == G0.dim() + 1:
            return G0[..., None] * fad
        return G0 * fad

    @staticmethod
    def rsrp(G, P):
        if G.dim() == 3:
            return G * P[None, :, :]
        return G[:, :, None] * P[None, :, :]

    def se_of_gamma(self, gamma):
        """(se, cqi) at the configured reporting resolution."""
        p = self.p
        s = p.n_rb_subbands
        if p.cqi_report == "wideband" and s > 1:
            shp = gamma.shape
            g = gamma.reshape(shp[:-1] + (shp[-1] // s, s))
            beta = p.cqi_eesm_beta
            eff = -beta * (torch.logsumexp(-g / beta, dim=-1)
                           - float(np.log(np.float32(s))))
            gamma = eff[..., None].expand(eff.shape + (s,)).reshape(shp)
        cqi = phy.sinr_db_to_cqi(phy.sinr_to_db(gamma))
        se = torch.where(cqi > 0, phy.mcs_to_efficiency(phy.cqi_to_mcs(cqi)),
                         0.0)
        return se, cqi

    def chain(self, U, static, P, fad, a_fixed):
        """One dense pass: ``(se, cqi, a, meas_wb)`` for every UE, serving
        ``a_fixed`` when given (A3 carries it), else the best cell."""
        dt = self.dtype
        G0 = self.gains(U, static)
        P = P.to(dt)
        R = self.rsrp(self.faded(G0, fad.to(dt)), P)
        R_meas = self.rsrp(G0, P) if self.attach_on_mean else R
        meas_wb = R_meas.sum(dim=2)
        a = (torch.argmax(meas_wb, dim=1).to(torch.int32) if a_fixed is None
             else a_fixed)
        w = torch.gather(R, 1, a.long()[:, None, None].expand(
            R.shape[0], 1, R.shape[2]))[:, 0]
        u = R.sum(dim=1) - w
        gamma = w / (self.noise_w + u)
        se, cqi = self.se_of_gamma(gamma)
        return se.to(F32), cqi, a, meas_wb

    # -- one TTI -----------------------------------------------------------
    def tti(self, setup: Setup, state: dict, draws: Draws, t: int,
            action=None, fairness_p=None):
        """Advance ``state`` (a dict of the episode's leaves) by TTI ``t``:
        returns ``(state, tput, telemetry)``."""
        p, dev = self.p, self.device
        static, n, m = setup.static, p.n_ues, setup.n_cells
        U, buf, avg = state["U"], state["backlog"], state["pf_avg"]
        hbits, hretx = state["harq_bits"], state["harq_retx"]
        a_srv, ttt = state["serving"], state["ttt"]
        act, fad = state.get("active"), state.get("fad")
        if fad is None:
            fad = static.fad
        P = static.P if action is None else action
        U = U.to(self.dtype)
        prev_srv = a_srv
        tti_s = p.tti_s
        born = None
        # -- churn: departures idle out, newborns take the lowest free slots
        if self.churn is not None:
            ch = self.churn
            p_dep, lam = mobility.churn_rates(tti_s, ch)
            g = draws.churn(BIRTH, t)
            n_poisson = torch.poisson(torch.full((), float(lam), dtype=F32,
                                                 device=dev), generator=g)
            g = draws.churn(DEATH, t)
            depart = torch.rand((n,), generator=g, device=dev) < p_dep
            act, born, n_born = mobility.birth_death_step(n_poisson, depart,
                                                          act, ch)
            buf = torch.where(act, buf, 0.0)
            avg = torch.where(act, avg, 0.0)
            hbits = torch.where(act, hbits, 0.0)
            hretx = torch.where(act, hretx, 0)
            ttt = torch.where(act, ttt, 0)
            buf = torch.where(born, ch.newborn_backlog_bits, buf)
            avg = torch.where(born, 0.0, avg)
            hbits = torch.where(born, 0.0, hbits)
            hretx = torch.where(born, 0, hretx)
            ttt = torch.where(born, 0, ttt)
            k = ch.max_arrivals_per_tti
            slots = torch.nonzero(born).flatten()    # ascending free slots
            fresh_U = deploy.ppp_points(draws.churn(POSITION, t), k,
                                        p.extent_m, z=p.h_ut_m)
            U = U.clone()
            U[slots] = fresh_U[:slots.numel()].to(U.dtype)
            if p.rayleigh_fading and state.get("fad") is not None:
                fresh_f = self.draw_fading(draws.churn(CHURN_FADING, t), k, m)
                fad = fad.clone()
                fad[slots] = fresh_f[:slots.numel()]
        # -- cell faults ---------------------------------------------------
        cs = state.get("cell_state")
        if self.faults is not None:
            if cs is None:                   # a fresh episode: all cells UP
                cs = sim_faults.init_cell_state(m, dev)
            u = torch.rand((m,), generator=draws.gen(_FAULT, t), device=dev)
            cs, _ = sim_faults.fault_step(u, cs, tti_s, self.faults)
            P = P * sim_faults.tx_multiplier(cs, self.faults)[:, None]
        # -- mobility --------------------------------------------------------
        if p.mobility_step_m:
            g = draws.legacy(MOBILITY, t)
            frac = p.mobility_move_frac
            if frac is not None and frac < 1.0:
                n_move = max(1, int(round(frac * n)))
                start, d = mobility.window_movers(g, n, n_move,
                                                  p.mobility_step_m)
                rows = torch.arange(n, device=dev)
                d_all, _ = mobility.window_displacements(start, d, rows, n)
            else:
                d_all = mobility.walk_steps(g, n, p.mobility_step_m)
            U = mobility.apply_walk(U, d_all, p.extent_m)
        # -- the radio chain and the serving cell ----------------------------
        if p.ho_enabled:
            _, _, _, meas_wb = self.chain(U, static, P, fad, a_srv)
            if born is not None:
                a_srv = torch.where(born, torch.argmax(meas_wb, dim=1).to(
                    a_srv.dtype), a_srv)
            serving = torch.gather(meas_wb, 1, a_srv.long()[:, None])[:, 0]
            best = torch.argmax(meas_wb, dim=1).to(a_srv.dtype)
            best_val = meas_wb.max(dim=1).values
            hyst = 10.0 ** (p.ho_hysteresis_db / 10.0)
            entered = (best_val > serving * hyst) & (best != a_srv)
            ttt = torch.where(entered, ttt + 1, 0).to(torch.int32)
            fire = ttt >= p.ho_ttt_tti
            a_srv = torch.where(fire, best, a_srv)
            ttt = torch.where(fire, 0, ttt).to(torch.int32)
            se, cqi, a_use, _ = self.chain(U, static, P, fad, a_srv)
        else:
            se, cqi, a_use, _ = self.chain(U, static, P, fad, None)
            if self.faults is not None:
                a_srv = a_use
        # -- MAC -------------------------------------------------------------
        if self.traffic_step is not None:
            arrivals = self.traffic_step(draws.legacy(TRAFFIC, t))
            if act is not None:
                arrivals = torch.where(act, arrivals, 0.0)
            buf = buf + arrivals
        bler = p.harq_bler
        harq_on = bler > 0.0
        pending = hbits > 0.0 if harq_on else torch.zeros_like(
            buf, dtype=torch.bool)
        demand = (buf[:, None] > 0.0) | pending[:, None]
        if act is not None:
            demand = demand & act[:, None]
        active = demand & (se > 0.0)
        fp = p.fairness_p if fairness_p is None else fairness_p
        rb_bw = p.subband_bandwidth_Hz / p.n_rb
        log_w = scheduler.pf_log_weights_ewma(rb_bw * se, avg[:, None], fp)
        alloc = scheduler.allocate(p.scheduler_policy, active, cqi, a_use, m,
                                   p.rb_per_chunk, state["rr_cursor"], log_w)
        drainable = torch.where(pending, 0.0, buf)
        tb_new = scheduler.served_bits(alloc, se, drainable, rb_bw,
                                       tti_s).sum(dim=-1)
        i32 = torch.int32
        if harq_on:
            g = draws.legacy(HARQ, t)
            u = torch.rand((n,), generator=g, device=dev)
            granted = alloc.sum(dim=-1) > 0.0
            tb = torch.where(pending, hbits, tb_new)
            attempting = granted & (tb > 0.0)
            attempt = torch.where(pending, hretx, 0)
            gain = 10.0 ** (p.harq_comb_gain_db / 10.0)
            p_fail = torch.clamp(bler * torch.pow(gain, -attempt.to(F32)),
                                 0.0, 1.0)
            ok = (u >= p_fail) & attempting
            fail = ~ok & attempting
            n_fail = attempt + 1
            keep = (fail & (n_fail <= p.harq_max_retx)) | (pending & ~granted)
            bits = torch.where(ok, tb, 0.0)
            hstats = (ok.sum().to(i32), fail.sum().to(i32),
                      (pending & attempting).sum().to(i32),
                      torch.where(fail & (n_fail > p.harq_max_retx), tb,
                                  0.0).sum())
            hbits = torch.where(keep, tb, 0.0)
            hretx = torch.where(keep, torch.where(fail, n_fail, hretx),
                                0).to(i32)
            buf = torch.clamp(buf - tb_new, min=0.0)
        else:
            bits = tb_new
            zero = torch.zeros((), dtype=i32, device=dev)
            hstats = ((bits > 0.0).sum().to(i32), zero, zero,
                      torch.zeros((), dtype=F32, device=dev))
            buf = torch.clamp(buf - bits, min=0.0)
        tput = bits / tti_s
        avg = (1.0 - p.pf_ewma) * avg + p.pf_ewma * tput
        new = dict(state, U=U, backlog=buf, pf_avg=avg,
                   rr_cursor=state["rr_cursor"] + p.rb_per_chunk,
                   harq_bits=hbits, harq_retx=hretx, serving=a_srv, ttt=ttt,
                   t=state["t"] + 1)
        if act is not None:
            new["active"] = act
        if state.get("fad") is not None:
            new["fad"] = fad
        if cs is not None:
            new["cell_state"] = cs
        count = lambda x: x.sum().to(i32)
        zero = torch.zeros((), dtype=i32, device=dev)
        telem = telemetry.tti_telemetry(
            m, n, a_use, alloc, bits, tput, buf, hstats,
            count(a_srv != prev_srv) if p.ho_enabled else zero,
            None, active_count=count(act) if act is not None else None,
            cells_down=(count(cs == sim_faults.DOWN)
                        if self.faults is not None else None),
            reattached=(count(a_srv != prev_srv)
                        if self.faults is not None else None))
        return new, tput, telem

    def rollout(self, setup: Setup, state: dict, n_tti: int, seed: int,
                action=None, fairness_p=None):
        """``n_tti`` TTIs from ``state``: ``(state, tput (n_tti, n),
        [telemetry])``."""
        draws = Draws(seed, self.device)
        t0 = int(state["t"])
        tputs, telems = [], []
        for t in range(t0, t0 + n_tti):
            state, tput, telem = self.tti(setup, state, draws, t, action,
                                          fairness_p)
            tputs.append(tput)
            telems.append(telem)
        return state, torch.stack(tputs), telems
