"""The TTI engine: an episode as a Python loop of shape-static TTI steps.

The port of ``repro.mac.engine`` on one device.  One TTI is a function of
an explicit :class:`EpisodeState`; :func:`make_episode_fns` builds
``step`` and ``rollout`` for one configuration.  The loop body has static
shapes and reads nothing back to the host: ``rollout`` reads the TTI
counter once before its loop.

Randomness comes from a :class:`Draws` object with one method per stream
(mobility, fading, traffic, HARQ), the counterpart of ``radio.tti_keys``.
The default seeds one ``torch.Generator`` per (stream, absolute TTI) from
an episode seed, so a TTI is reproducible on its own; tests hand the
engine the JAX reference's own draws instead.

Covered: dense and incremental radio modes (``inc_backend`` ``None`` /
``"torch"`` / ``"fused"`` / ``"auto"``), static and per-TTI fading, walk
and window mobility, rr / max_cqi / pf with a per-call ``fairness_p``
override, stop-and-wait HARQ and HARQ-lite, A3 handover, and per-TTI KPI
telemetry (``repro_torch.obs.telemetry``).  Mesh sharding, churn, faults
and the relaxed (differentiable) chain wait for later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import not_in_slice
from repro_torch.mac import scheduler as mac_sched
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.sim import deploy, mobility, radio

# stream ids of the per-TTI draws (the order of radio.tti_keys)
MOBILITY, FADING, TRAFFIC, HARQ = range(4)


class EpisodeState(NamedTuple):
    """The full mutable state of a MAC episode.  ``rr_cursor`` and ``t``
    are 0-dim int32 tensors; per-UE integers are int32, floats float32."""

    U: Any           # (n_ues, 3) positions
    backlog: Any     # (n_ues,) queued bits (inf = full buffer)
    pf_avg: Any      # (n_ues,) PF EWMA average delivered rate, bits/s
    rr_cursor: Any   # i32 scalar: round-robin rotation state
    harq_bits: Any   # (n_ues,) f32 pending transport-block bits (0 = idle)
    harq_retx: Any   # (n_ues,) i32 retransmission count of the pending TB
    serving: Any     # (n_ues,) i32 serving-cell index (A3 carried state)
    ttt: Any         # (n_ues,) i32 A3 time-to-trigger counters
    t: Any           # i32 scalar: TTI index (drives the draws)
    #: int64 scalar: the episode seed of ``repro_torch.env.CrrmEnv`` (the
    #: counterpart of the reference's PRNG ``key``); None outside the env
    seed: Any = None


class EpisodeStatic(NamedTuple):
    """Per-episode radio inputs: everything the step reads but never writes."""

    se: Any          # (n_ues, n_freq) spectral efficiency
    cqi: Any         # (n_ues, n_freq)
    a: Any           # (n_ues,) i32 attachment
    C: Any           # (n_cells, 3) cell positions
    P: Any           # (n_cells, n_freq) tx power
    bore: Any        # (n_cells,) sector boresights
    fad: Any         # (n_ues, n_cells[, n_freq]) fading factor


class EpisodeFns(NamedTuple):
    """``step(static, state, draws, action=None, fairness_p=None) ->
    (state, tput)`` and ``rollout(static, state, n_tti, draws, action=None,
    fairness_p=None) -> (state, tput)`` with ``tput`` stacked to
    (n_tti, n_ues).  Built with ``telemetry=True`` both return a third
    value, the TTI's :class:`~repro_torch.obs.telemetry.Telemetry` (stacked
    to (n_tti, ...) by ``rollout``)."""

    step: Any
    rollout: Any


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The splitmix64 finaliser, a bijection of 64-bit integers.  A CPU
    ``torch.Generator`` (mt19937) keeps only the low 32 bits of its seed,
    so the (episode seed, stream, TTI) key is mixed into all 64 first."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class Draws:
    """The per-TTI random draws of an episode, one method per stream.

    Each (stream, absolute TTI) pair gets its own ``torch.Generator`` on
    ``device``, seeded from ``seed``, so any TTI is reproducible on its own
    (as the reference's ``fold_in(key, 4 * t + i)`` lineage is).  The
    topology and fading of a resampled env reset come from two generators
    of their own, apart from every per-TTI stream (the counterpart of
    ``radio.reset_keys``).  A subclass may replay other draws by overriding
    the methods.
    """

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _seeded(self, offset: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_splitmix64(((self.seed & 0x7FFFFFFF) << 32) + offset))
        return g

    def generator(self, stream: int, t: int) -> torch.Generator:
        return self._seeded(4 * int(t) + stream)

    def topology(self, n, extent_m, z):
        """(n, 3) UE positions of a resampled reset (``deploy.ppp_points``)."""
        return deploy.ppp_points(self._seeded(1 << 31), n, extent_m, z=z)

    def topology_fading(self, cfg, n_ues, n_cells):
        """The fading draw of a resampled reset (``radio.draw_fading``)."""
        return radio.draw_fading(cfg, self._seeded((1 << 31) + 1), n_ues,
                                 n_cells)

    def walk(self, t, n, step_m):
        """(n, 2) every-UE random-walk displacements."""
        return mobility.walk_steps(self.generator(MOBILITY, t), n, step_m)

    def window(self, t, n, n_move, step_m):
        """(start, (n_move, 2) displacements) of the window movers."""
        return mobility.window_movers(self.generator(MOBILITY, t), n, n_move,
                                      step_m)

    def fading(self, t, cfg, n_ues, n_cells):
        return radio.draw_fading(cfg, self.generator(FADING, t), n_ues,
                                 n_cells)

    def traffic(self, t, traffic_step):
        """Arrival bits of the traffic model's ``step(gen)``."""
        return traffic_step(self.generator(TRAFFIC, t))

    def harq_uniform(self, t, n):
        g = self.generator(HARQ, t)
        return torch.rand((n,), generator=g, device=g.device)

    def harq_bernoulli(self, t, p, n):
        """(n,) bool, True with probability ``p``."""
        return self.harq_uniform(t, n) < p


def harq_fail_prob(bler, comb_gain_db, retx):
    """Conditional failure probability of HARQ attempt number ``retx``:
    ``bler / 10^(retx * gain_db / 10)``."""
    gain = 10.0 ** (comb_gain_db / 10.0)
    return torch.clamp(bler * torch.pow(gain, -retx.to(torch.float32)),
                       0.0, 1.0)


def a3_handover(a, ttt, rsrp_wb, hyst_db, ttt_tti):
    """One TTI of the A3 trigger: (serving, time-to-trigger) -> updated.

    A3 enters when the best neighbour's wideband RSRP exceeds the serving
    cell's by ``hyst_db``; after ``ttt_tti`` consecutive TTIs the UE hands
    over.  Leaving the condition resets the counter.
    """
    serving = torch.gather(rsrp_wb, 1, a.long()[:, None])[:, 0]
    best = torch.argmax(rsrp_wb, dim=1).to(a.dtype)
    best_val = rsrp_wb.max(dim=1).values
    hyst = 10.0 ** (hyst_db / 10.0)
    entered = (best_val > serving * hyst) & (best != a)
    ttt = torch.where(entered, ttt + 1, 0).to(torch.int32)
    fire = ttt >= ttt_tti
    a = torch.where(fire, best, a)
    ttt = torch.where(fire, 0, ttt).to(torch.int32)
    return a, ttt


def stationary_served_tput(params, n_cells: int, se, cqi, a, backlog):
    """The graph's Schedule -> ServedThroughput chain on explicit tensors:
    the single-shot served throughput at the stationary alpha-fair point."""
    p = params
    active = (backlog[:, None] > 0.0) & (se > 0.0)
    log_w = mac_sched.pf_log_weights_stationary(se, p.fairness_p)
    alloc = mac_sched.allocate(p.scheduler_policy, active, cqi, a, n_cells,
                               p.rb_per_chunk, 0, log_w)
    bits = mac_sched.served_bits(alloc, se, backlog,
                                 p.subband_bandwidth_Hz / p.n_rb, p.tti_s)
    return (bits / p.tti_s).sum(dim=1)


_LATER = {"mesh": "mesh", "cell_axis": "mesh", "churn": "churn",
          "relax": "RL", "faults": "faults"}


def _reject_later(**kw):
    """Raise for any feature of a later slice that the caller asked for."""
    for name, value in kw.items():
        if value:
            raise not_in_slice(f"episode_fns({name}=...)", _LATER[name])


def make_episode_fns(params, n_ues: int, n_cells: int,
                     radio_cfg: "radio.RadioConfig", traffic_step, *,
                     mobility_step_m=None, per_tti_fading: bool = False,
                     use_harq=None, radio_mode: str = "dense",
                     mobility_move_frac=None, inc_backend=None,
                     mesh=None, cell_axis=None, telemetry: bool = False,
                     churn=None, relax=None, faults=None) -> EpisodeFns:
    """Build the ``step``/``rollout`` functions for one configuration.

    ``traffic_step(gen)`` is the traffic model's arrival draw (``None`` for
    full buffer).  ``use_harq`` forces the HARQ state machine on or off
    (None = on iff ``harq_bler > 0``).  ``radio_mode="incremental"``
    carries a ``radio.RadioState`` and recomputes only the mover rows per
    TTI; ``inc_backend`` routes that recompute: ``None``/``"torch"`` is
    ``radio.radio_update_rows``, ``"fused"`` is
    ``radio.radio_update_rows_fused`` (the CUDA kernel on CUDA tensors) and
    raises where the kernel cannot express the regime (handover tables,
    non-stock sector patterns), and ``"auto"`` is ``"fused"`` exactly when
    it can.

    ``telemetry=True`` adds a per-TTI
    :class:`~repro_torch.obs.telemetry.Telemetry` to both functions'
    returns; it draws nothing and touches no state, so the trajectory is
    bit-identical either way.  Both functions take ``fairness_p=None``: a
    scalar overriding ``params.fairness_p`` in the PF weights for that
    call, its alpha-fair exponent computed in float32 as the reference
    computes a traced override.
    """
    _reject_later(mesh=mesh, cell_axis=cell_axis, churn=churn, relax=relax,
                  faults=faults)
    p = params
    cfg = radio_cfg
    tti_s, beta = p.tti_s, p.pf_ewma
    rb_chunk = p.rb_per_chunk
    rb_bw = p.subband_bandwidth_Hz / p.n_rb     # physical RB bandwidth
    policy, bler = p.scheduler_policy, p.harq_bler
    harq_on = bler > 0.0 if use_harq is None else bool(use_harq)
    max_retx, comb_db = p.harq_max_retx, p.harq_comb_gain_db
    ho_on = p.ho_enabled
    hyst_db, ttt_tti = p.ho_hysteresis_db, p.ho_ttt_tti
    noise_w = p.chunk_noise_W
    attach_on_mean = p.rayleigh_fading and p.attach_ignores_fading
    static_geom = mobility_step_m is None
    if radio_mode not in ("dense", "incremental"):
        raise ValueError(f"radio_mode must be 'dense' or 'incremental'; "
                         f"got {radio_mode!r}")
    incremental = radio_mode == "incremental"
    if incremental and per_tti_fading:
        raise ValueError(
            "radio_mode='incremental' is incompatible with per_tti_fading: "
            "a per-TTI fading redraw dirties every UE row every TTI, so "
            "the dense recompute IS the minimal update")
    frac_on = (mobility_step_m is not None and mobility_move_frac is not None
               and mobility_move_frac < 1.0)
    n_move = (max(1, int(round(mobility_move_frac * n_ues))) if frac_on
              else n_ues)

    if inc_backend not in radio.BACKENDS:
        raise ValueError(f"inc_backend must be one of {radio.BACKENDS}; "
                         f"got {inc_backend!r}")
    inc_fused = False
    if incremental and inc_backend in ("auto", "fused"):
        if ho_on:
            reason = ("handover regimes carry per-candidate-cell tables "
                      "(se_all) the streaming kernel never materialises")
        else:
            reason = radio.fused_unsupported_reason(cfg)
        if inc_backend == "fused" and reason is not None:
            raise ValueError(f"inc_backend='fused' cannot express this "
                             f"configuration: {reason}")
        inc_fused = reason is None

    def use_rs(power_act: bool) -> bool:
        """Does this specialisation run on a RadioState?  It is carried
        when mobility dirties rows; a static-geometry power action's chain
        is computed once and held constant."""
        return incremental and (not static_geom or power_act)

    def inc_fad(static):
        """The incremental chain's fading: ``None`` on the unfaded channel."""
        return static.fad if p.rayleigh_fading else None

    def init_rs(static, U, action):
        P = static.P if action is None else action
        return radio.radio_init(cfg, U, static.C, static.bore,
                                inc_fad(static), P, with_tables=ho_on)

    def walk_displacements(draws, t, U):
        """This TTI's per-row displacement + the window start (or None when
        every UE walks)."""
        if frac_on:
            start, d = draws.window(t, n_ues, n_move, mobility_step_m)
            rows = torch.arange(n_ues, device=U.device)
            d_all, _ = mobility.window_displacements(start, d, rows, n_ues)
            return d_all, start
        return draws.walk(t, n_ues, mobility_step_m), None

    def inc_channel(static, rs, U, P, draws, t, fad):
        """One incremental TTI of the radio chain: move, patch, read.
        Returns ``(U, rs, n_dirty)``: the number of recomputed rows as an
        int32 scalar tensor, or the int 0 when nothing moves."""
        n_dirty = 0
        if mobility_step_m is not None:
            d, start = walk_displacements(draws, t, U)
            U = mobility.apply_walk(U, d, p.extent_m)
            if start is None:
                idx = torch.arange(n_ues, dtype=torch.int32, device=U.device)
                n_dirty = n_ues
            else:
                idx, n_dirty = radio.window_indices(start, n_move, n_ues)
            if inc_fused:
                rs = radio.radio_update_rows_fused(
                    cfg, rs, U, static.C, static.bore, fad, P, idx)
            else:
                rs = radio.radio_update_rows(cfg, rs, U, static.C,
                                             static.bore, fad, P, idx)
        return U, rs, n_dirty

    def sinr_chain(R, a):
        gamma, _, _ = radio.sinr(R, a, noise_w)
        se, cqi = radio.se_chain(cfg, gamma)
        return se, cqi, a

    def gather_serving(se_all, cqi_all, a):
        return radio.take_cell(se_all, a), radio.take_cell(cqi_all, a)

    def allocate(se, cqi, a, buf, avg, cursor, harq_pending, fair):
        demand = (buf[:, None] > 0.0) | harq_pending[:, None]
        active = demand & (se > 0.0)
        fp = p.fairness_p if fair is None else fair
        log_w = mac_sched.pf_log_weights_ewma(rb_bw * se, avg[:, None], fp)
        return mac_sched.allocate(policy, active, cqi, a, n_cells, rb_chunk,
                                  cursor, log_w)

    def harq_step(draws, t, tb_new, hbits, hretx, granted):
        """One TTI of every UE's stop-and-wait process: pending UEs
        retransmit their stored TB when granted; fresh TBs enter the
        machine on failure and drop after ``max_retx`` retransmissions.
        The fourth return is the TTI's ``(acks, nacks, retx, dropped_bits)``
        telemetry tuple (None unless telemetry is on)."""
        pending = hbits > 0.0
        tb = torch.where(pending, hbits, tb_new)
        attempting = granted & (tb > 0.0)
        attempt = torch.where(pending, hretx, 0)
        p_fail = harq_fail_prob(bler, comb_db, attempt)
        u = draws.harq_uniform(t, n_ues)
        ok = (u >= p_fail) & attempting
        fail = ~ok & attempting
        n_fail = attempt + 1
        keep = (fail & (n_fail <= max_retx)) | (pending & ~granted)
        delivered = torch.where(ok, tb, 0.0)
        stats = None
        if telemetry:
            i32 = torch.int32
            stats = (ok.sum().to(i32), fail.sum().to(i32),
                     (pending & attempting).sum().to(i32),
                     torch.where(fail & (n_fail > max_retx), tb, 0.0).sum())
        hbits = torch.where(keep, tb, 0.0)
        hretx = torch.where(keep, torch.where(fail, n_fail, hretx), 0)
        return delivered, hbits, hretx.to(torch.int32), stats

    def prepare(static, U, power_act: bool):
        """Loop-invariant constants of the static-geometry regime."""
        h = {}
        if use_rs(power_act):
            return h
        if static_geom and (per_tti_fading or ho_on or power_act):
            h["G"] = radio.pathgains(cfg, U, static.C, static.bore)
            if not power_act:
                R_mean = radio.rsrp(h["G"], static.P)
                h["R_mean"] = R_mean
                h["a"] = radio.attachment(R_mean) if attach_on_mean else None
                R_faded = radio.rsrp(radio.apply_fading(h["G"], static.fad),
                                     static.P)
                h["meas_wb"] = (R_mean if attach_on_mean
                                else R_faded).sum(dim=-1)
                if ho_on:
                    # static channel + evolving serving cell: tabulate the
                    # SINR chain for every candidate cell once
                    total = R_faded.sum(dim=1)
                    gamma_all = R_faded / (
                        noise_w + (total[:, None, :] - R_faded))
                    h["se_all"], h["cqi_all"] = radio.se_chain(cfg, gamma_all)
        return h

    def tti_step(h, static, state, action, rs, draws, t: int, fair):
        """One TTI: (hoisted, static, state, action, radio-state) ->
        (state, tput, radio-state, telemetry).  ``t`` is the TTI as a
        Python int, ``fair`` the fairness override (None = the params');
        telemetry is None unless built with ``telemetry=True``."""
        power_act = action is not None
        U, buf, avg = state.U, state.backlog, state.pf_avg
        cursor, hbits = state.rr_cursor, state.harq_bits
        hretx = state.harq_retx
        a_srv, ttt = state.serving, state.ttt
        prev_srv = a_srv
        n_dirty = 0 if incremental else None
        P = action if power_act else static.P
        # -- channel: incremental state, per-TTI recompute, or constants ---
        r = rs if rs is not None else h.get("rs")
        if r is not None:
            if rs is not None:              # carried: mobility dirties rows
                U, r, n_dirty = inc_channel(static, r, U, P, draws, t,
                                            inc_fad(static))
                rs = r
            if ho_on:
                a_srv, ttt = a3_handover(a_srv, ttt, r.meas, hyst_db, ttt_tti)
                a_use = a_srv
                se, cqi = gather_serving(r.se_all, r.cqi_all, a_use)
            else:
                se, cqi, a_use = r.se, r.cqi, r.a
        elif mobility_step_m is not None:
            d, _ = walk_displacements(draws, t, U)
            U = mobility.apply_walk(U, d, p.extent_m)
            G0 = radio.pathgains(cfg, U, static.C, static.bore)
            fad = (draws.fading(t, cfg, n_ues, n_cells) if per_tti_fading
                   else static.fad)
            R = radio.rsrp(radio.apply_fading(G0, fad), P)
            R_meas = radio.rsrp(G0, P) if attach_on_mean else R
            a_inst = radio.attachment(R_meas)
        elif per_tti_fading or power_act:
            fad = (draws.fading(t, cfg, n_ues, n_cells) if per_tti_fading
                   else static.fad)
            R = radio.rsrp(radio.apply_fading(h["G"], fad), P)
            if power_act:
                R_meas = radio.rsrp(h["G"], P) if attach_on_mean else R
                a_inst = radio.attachment(R_meas)
            else:
                R_meas = h["R_mean"] if attach_on_mean else R
                a_inst = h["a"] if attach_on_mean else radio.attachment(R)
        else:
            R = R_meas = a_inst = None   # fully static radio chain

        # -- serving cell: A3 carried state, or instantaneous argmax ------
        if r is None:
            if ho_on:
                meas_wb = (R_meas.sum(dim=-1) if R_meas is not None
                           else h["meas_wb"])
                a_srv, ttt = a3_handover(a_srv, ttt, meas_wb, hyst_db,
                                         ttt_tti)
                a_use = a_srv
                if R is not None:
                    se, cqi, _ = sinr_chain(R, a_use)
                else:
                    se, cqi = gather_serving(h["se_all"], h["cqi_all"], a_use)
            elif R is not None:
                se, cqi, a_use = sinr_chain(R, a_inst)
            else:
                se, cqi, a_use = static.se, static.cqi, static.a

        # -- MAC: traffic -> grant -> HARQ -> drain ------------------------
        if traffic_step is not None:
            buf = buf + draws.traffic(t, traffic_step)
        harq_pending = ((hbits > 0.0) if harq_on
                        else torch.zeros_like(buf, dtype=torch.bool))
        alloc = allocate(se, cqi, a_use, buf, avg, cursor, harq_pending, fair)
        drainable = torch.where(harq_pending, 0.0, buf)
        tb_new = mac_sched.served_bits(alloc, se, drainable, rb_bw,
                                       tti_s).sum(dim=1)
        hstats = None
        if harq_on:
            bits, hbits, hretx, hstats = harq_step(
                draws, t, tb_new, hbits, hretx, alloc.sum(dim=1) > 0.0)
        elif bler > 0.0:   # HARQ-lite: lost blocks stay queued -> retx
            bits = tb_new * draws.harq_bernoulli(t, 1.0 - bler, n_ues).to(
                tb_new.dtype)
        else:
            bits = tb_new
        # clamp: served_bits <= backlog only up to float rounding
        buf = torch.clamp(buf - (tb_new if harq_on else bits), min=0.0)
        tput = bits / tti_s
        avg = (1.0 - beta) * avg + beta * tput
        state = EpisodeState(U, buf, avg, cursor + rb_chunk, hbits, hretx,
                             a_srv, ttt, state.t + 1, state.seed)
        telem = None
        if telemetry:
            telem = step_telemetry(a_use, alloc, bits, tb_new, tput, buf,
                                   hstats, a_srv, prev_srv, n_dirty)
        return state, tput, rs, telem

    def step_telemetry(a_use, alloc, bits, tb_new, tput, buf, hstats, a_srv,
                       prev_srv, n_dirty):
        """The TTI's KPIs, only from values the step computed."""
        i32, dev = torch.int32, buf.device
        zero = lambda: torch.zeros((), dtype=i32, device=dev)
        if hstats is None:
            acks = (bits > 0.0).sum().to(i32)
            nacks = (((tb_new > 0.0) & (bits == 0.0)).sum().to(i32)
                     if bler > 0.0 else zero())
            hstats = (acks, nacks, zero(),
                      torch.zeros((), dtype=torch.float32, device=dev))
        ho_fired = (a_srv != prev_srv).sum().to(i32) if ho_on else zero()
        if isinstance(n_dirty, int):
            n_dirty = torch.full((), n_dirty, dtype=i32, device=dev)
        return obs_telemetry.tti_telemetry(n_cells, n_ues, a_use, alloc, bits,
                                           tput, buf, hstats, ho_fired,
                                           n_dirty)

    def setup(static, state, action):
        """(hoisted constants, carried RadioState) for one specialisation."""
        h = prepare(static, state.U, action is not None)
        rs0 = None
        if use_rs(action is not None):
            if static_geom:
                h["rs"] = init_rs(static, state.U, action)
            else:
                rs0 = init_rs(static, state.U, action)
        return h, rs0

    def fairness(fairness_p, device):
        """The override as a float32 scalar tensor (None stays None)."""
        if fairness_p is None:
            return None
        return torch.as_tensor(fairness_p, dtype=torch.float32,
                               device=device)

    def step(static, state, draws, action=None, fairness_p=None):
        h, rs0 = setup(static, state, action)
        fair = fairness(fairness_p, state.backlog.device)
        state, tput, _, telem = tti_step(h, static, state, action, rs0, draws,
                                         int(state.t), fair)
        return (state, tput, telem) if telemetry else (state, tput)

    def rollout(static, state, n_tti, draws, action=None, fairness_p=None):
        h, rs = setup(static, state, action)
        fair = fairness(fairness_p, state.backlog.device)
        t0 = int(state.t)          # the one host read, before the loop
        tputs, telems = [], []
        for t in range(t0, t0 + n_tti):
            state, tput, rs, telem = tti_step(h, static, state, action, rs,
                                              draws, t, fair)
            tputs.append(tput)
            telems.append(telem)
        if telemetry:
            return state, torch.stack(tputs), obs_telemetry.stack(telems)
        return state, torch.stack(tputs)

    return EpisodeFns(step=step, rollout=rollout)


def episode_fns_for(sim, *, mobility_step_m=None, per_tti_fading=False,
                    use_harq=None, radio_mode=None, mobility_move_frac=None,
                    inc_backend=None, telemetry: bool = False,
                    **later) -> EpisodeFns:
    """The :func:`make_episode_fns` bundle for ``sim``, cached on it.

    ``mobility_step_m=None`` falls back to ``params.mobility_step_m``
    (``0`` forces static geometry); ``radio_mode`` and
    ``mobility_move_frac`` fall back to their ``CRRM_parameters`` fields.
    """
    _reject_later(**later)
    if mobility_step_m is None:
        mobility_step_m = sim.params.mobility_step_m
    if not mobility_step_m:          # 0 / None -> static geometry
        mobility_step_m = None
    if radio_mode is None:
        radio_mode = sim.params.radio_mode
    if mobility_move_frac is None:
        mobility_move_frac = sim.params.mobility_move_frac
    cache_key = (mobility_step_m, per_tti_fading, use_harq, radio_mode,
                 mobility_move_frac, inc_backend, bool(telemetry))
    cache = sim.__dict__.setdefault("_episode_fns_cache", {})
    if cache_key not in cache:
        cache[cache_key] = make_episode_fns(
            sim.params, sim.n_ues, sim.n_cells, sim.radio_config(),
            sim._traffic_step, mobility_step_m=mobility_step_m,
            per_tti_fading=per_tti_fading, use_harq=use_harq,
            radio_mode=radio_mode, mobility_move_frac=mobility_move_frac,
            inc_backend=inc_backend, telemetry=bool(telemetry))
    return cache[cache_key]


def run_episode(sim, n_tti: int, draws=None, mobility_step_m=None,
                per_tti_fading: bool = False, sync_state: bool = True,
                use_harq=None, radio_mode=None, mobility_move_frac=None,
                inc_backend=None, telemetry: bool = False, **later):
    """Run ``n_tti`` TTIs; returns (n_tti, n_ues) delivered throughput
    (bits/s), or ``(tput, telem)`` with ``telemetry=True``.  ``draws``
    defaults to ``Draws(params.seed, sim.device)``; ``sync_state`` writes
    the final state back into the graph."""
    fns = episode_fns_for(sim, mobility_step_m=mobility_step_m,
                          per_tti_fading=per_tti_fading, use_harq=use_harq,
                          radio_mode=radio_mode,
                          mobility_move_frac=mobility_move_frac,
                          inc_backend=inc_backend, telemetry=telemetry,
                          **later)
    if draws is None:
        draws = Draws(sim.params.seed, sim.device)
    state, tput, *telem = fns.rollout(sim.episode_static(),
                                      sim.init_episode_state(), n_tti, draws)
    if mobility_step_m is None:
        mobility_step_m = sim.params.mobility_step_m
    if sync_state:
        sim.sync_episode_state(state, positions=bool(mobility_step_m))
    return (tput, telem[0]) if telemetry else tput
