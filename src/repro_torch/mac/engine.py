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
override, stop-and-wait HARQ and HARQ-lite, A3 handover, per-TTI KPI
telemetry (``repro_torch.obs.telemetry``), the birth-death UE process
(``churn=``), the per-cell fault process (``faults=``), and a batch of
envs: a state whose leaves lead with B, each env with its own seed, TTI
counter and ``Draws``.  Churn and faults draw from lineages of their own,
so turning them on leaves the mobility, fading, traffic and HARQ draws
bit-identical.  ``relax=`` (a ``radio.RelaxConfig``) softens the
recomputed chain for ``torch.autograd``: single device, dense radio, no
churn and no faults.

Mesh sharding (``mesh=``, a ``core.distributed.Mesh``): every rank is
called with the global inputs, runs the TTIs on its own block of UE rows
(the ``ue_axis`` mesh axes) and, with ``cell_axis``, of cells, and returns
the global outputs.  Every per-UE draw is taken at global shape and
sliced, so rank s consumes exactly the rows it owns on one device; the
scheduler's per-cell reductions, the cell-sharded chain and the
telemetry reduce over the mesh with all-reduces.  Against one device:
bitwise for rr and max_cqi, and for attachment, serving cell and
positions; within 1e-5 for pf's floats, whose cross-shard sum reorders a
float reduction (under bursty traffic an ulp residue can flip a
backlog-active mask, so pf is held at full buffer).

Each call, TTI and stage runs inside a host-only span named in
``repro_torch.obs.profile.SPANS`` (``crrm.rollout``, ``crrm.tti``,
``crrm.radio``, ``crrm.sched``, ...), so a profiler trace ties every
kernel to the stage that launched it; with no profiler recording a span
costs one flag read.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import distributed as mesh_ops
from repro_torch.mac import scheduler as mac_sched
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.profile import annotate
from repro_torch.sim import deploy, mobility, radio
from repro_torch.sim import faults as sim_faults

# stream ids of the per-TTI draws (the order of radio.tti_keys)
MOBILITY, FADING, TRAFFIC, HARQ = range(4)
# stream ids of the churn lineage (the order of radio.churn_keys)
BIRTH, DEATH, POSITION, CHURN_FADING = range(4)
# draw lineages: each (lineage, offset) pair seeds its own generator
_LEGACY, _CHURN, _FAULT, _RESET = range(4)


class EpisodeState(NamedTuple):
    """The full mutable state of a MAC episode.  ``rr_cursor`` and ``t``
    are 0-dim int32 tensors; per-UE integers are int32, floats float32.

    A batch of B envs gives every leaf a leading B axis: ``t``,
    ``rr_cursor`` and ``seed`` become (B,), so each env keeps its own TTI
    counter and draws.  The three trailing leaves exist only under churn
    (``active``, ``fad``: :func:`seed_churn_state`) or faults
    (``cell_state``: :func:`seed_fault_state`, or all-UP by default) and
    are ``None`` otherwise."""

    U: Any           # (n_ues, 3) positions
    backlog: Any     # (n_ues,) queued bits (inf = full buffer)
    pf_avg: Any      # (n_ues,) PF EWMA average delivered rate, bits/s
    rr_cursor: Any   # i32 scalar: round-robin rotation state
    harq_bits: Any   # (n_ues,) f32 pending transport-block bits (0 = idle)
    harq_retx: Any   # (n_ues,) i32 retransmission count of the pending TB
    serving: Any     # (n_ues,) i32 serving-cell index (A3 carried state)
    ttt: Any         # (n_ues,) i32 A3 time-to-trigger counters
    t: Any           # i32 scalar: TTI index (drives the draws)
    #: int64 scalar: the episode seed the draws come from (the counterpart
    #: of the reference's PRNG ``key``; ``CRRM.init_episode_state`` sets it)
    seed: Any = None
    active: Any = None       # (n_ues,) bool live-UE mask | None (no churn)
    fad: Any = None          # carried fading factor | None (no churn)
    cell_state: Any = None   # (n_cells,) i32 fault codes | None (no faults)


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
    to (n_tti, ...) by ``rollout``).

    Batched: a ``state`` whose leaves lead with B and a sequence of B
    ``draws``; ``static``, ``action`` and ``fairness_p`` are shared or lead
    with B.  ``tput`` is then (B, n_ues) from ``step`` and
    (B, n_tti, n_ues) from ``rollout``, the telemetry likewise.

    ``inc_backend`` is the route the incremental rows take (``"torch"`` or
    ``"fused"``; ``None`` in dense mode) and ``inc_reason`` why the fused
    kernel cannot take them (``None`` when it can)."""

    step: Any
    rollout: Any
    inc_backend: Any = None
    inc_reason: Any = None


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """The splitmix64 finaliser, a bijection of 64-bit integers.  A CPU
    ``torch.Generator`` (mt19937) keeps only the low 32 bits of its seed,
    so every generator key is mixed into all 64 first."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class Draws:
    """The per-TTI random draws of an episode, one method per stream.

    Each (lineage, stream, absolute TTI) gets its own ``torch.Generator``
    on ``device``, keyed by ``splitmix64(splitmix64(seed) + (lineage << 32
    | offset))``: the whole 64-bit seed is mixed before the offset is
    added, so distinct seeds give distinct draws.  Four lineages, as the
    reference's key tags keep them apart: the legacy per-TTI streams
    (mobility, fading, traffic, HARQ at offset ``4 t + stream``), churn
    (birth, death, position, fading at ``4 t + stream``), faults (one
    uniform at ``t``) and a resampled reset's topology and fading.  Any
    TTI is reproducible on its own, and turning churn or faults on leaves
    the legacy streams untouched.  A subclass may replay other draws by
    overriding the methods.
    """

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._key = _splitmix64(self.seed & _M64)

    def _seeded(self, lineage: int, offset: int) -> torch.Generator:
        if not 0 <= offset < 1 << 32:
            raise ValueError(f"draw offset {offset} outside 32 bits")
        g = torch.Generator(device=self.device)
        g.manual_seed(_splitmix64((self._key + (lineage << 32 | offset))
                                  & _M64))
        return g

    def generator(self, stream: int, t: int) -> torch.Generator:
        return self._seeded(_LEGACY, 4 * int(t) + stream)

    def topology(self, n, extent_m, z):
        """(n, 3) UE positions of a resampled reset (``deploy.ppp_points``)."""
        return deploy.ppp_points(self._seeded(_RESET, 0), n, extent_m, z=z)

    def topology_fading(self, cfg, n_ues, n_cells):
        """The fading draw of a resampled reset (``radio.draw_fading``)."""
        return radio.draw_fading(cfg, self._seeded(_RESET, 1), n_ues,
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

    # -- the churn lineage -------------------------------------------------
    def _churn(self, stream: int, t: int) -> torch.Generator:
        return self._seeded(_CHURN, 4 * int(t) + stream)

    def churn_birth(self, t, lam):
        """0-dim float Poisson(``lam``) arrival count."""
        g = self._churn(BIRTH, t)
        rate = torch.full((), float(lam), dtype=torch.float32,
                          device=g.device)
        return torch.poisson(rate, generator=g)

    def churn_death(self, t, p, n):
        """(n,) bool departures, True with probability ``p``."""
        g = self._churn(DEATH, t)
        return torch.rand((n,), generator=g, device=g.device) < p

    def churn_positions(self, t, n, extent_m, z):
        """(n, 3) newborn positions (``deploy.ppp_points``)."""
        return deploy.ppp_points(self._churn(POSITION, t), n, extent_m, z=z)

    def churn_fading(self, t, cfg, n_ues, n_cells):
        """Newborn fading rows (``radio.draw_fading``)."""
        return radio.draw_fading(cfg, self._churn(CHURN_FADING, t), n_ues,
                                 n_cells)

    # -- the fault lineage -------------------------------------------------
    def fault_uniform(self, t, n_cells):
        """(n_cells,) uniforms of the TTI's fault transition."""
        g = self._seeded(_FAULT, int(t))
        return torch.rand((n_cells,), generator=g, device=g.device)


def harq_fail_prob(bler, comb_gain_db, retx):
    """Conditional failure probability of HARQ attempt number ``retx``:
    ``bler / 10^(retx * gain_db / 10)``."""
    gain = 10.0 ** (comb_gain_db / 10.0)
    return torch.clamp(bler * torch.pow(gain, -retx.to(torch.float32)),
                       0.0, 1.0)


def a3_handover(a, ttt, rsrp_wb, hyst_db, ttt_tti, cell_axis=None):
    """One TTI of the A3 trigger: (serving, time-to-trigger) -> updated.

    A3 enters when the best neighbour's wideband RSRP exceeds the serving
    cell's by ``hyst_db``; after ``ttt_tti`` consecutive TTIs the UE hands
    over.  Leaving the condition resets the counter.  Cell-sharded
    (``cell_axis``), the serving value is the owning shard's and the best
    neighbour the cross-shard argmax: the decisions are the single-device
    ones, bit for bit.
    """
    if cell_axis is None:
        serving = torch.gather(rsrp_wb, 1, a.long()[:, None])[:, 0]
        best = torch.argmax(rsrp_wb, dim=1).to(a.dtype)
        best_val = rsrp_wb.max(dim=1).values
    else:
        serving = radio.take_cell(rsrp_wb, a, cell_axis)
        best_val, best, _ = mesh_ops._global_best(
            rsrp_wb.amax(dim=1), torch.argmax(rsrp_wb, dim=1).to(a.dtype),
            rsrp_wb.shape[1], cell_axis)
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


def scatter_born(dst, idx, fresh, n_born):
    """Write the newborn rows ``fresh`` into ``dst`` at the padded born
    index ``idx`` (:func:`radio.dirty_indices`), in place; returns ``dst``.

    These writes are new values, so the row-0 padding would corrupt row 0
    whenever it is not a newborn: every padded slot is re-aimed at
    ``idx[0]`` and writes exactly what slot 0 writes there (``fresh[0]``
    when any birth happened, the row's current value when none).  All
    duplicate writes are then identical, so the result does not depend on
    the order in which ``index_put_`` writes them (on CUDA, none), and a
    zero-birth TTI leaves ``dst`` bitwise unchanged.  No host read.
    """
    k = idx.shape[0]
    sel = torch.arange(k, device=idx.device) < n_born
    idx = torch.where(sel, idx, idx[0]).long()
    # dst[idx[:1]] (a 1-row gather), not dst[idx[0]]: indexing with a
    # 0-dim tensor reads it back to the host
    base = torch.where(n_born > 0, fresh[0], dst[idx[:1]][0])
    write = torch.where(sel.reshape((k,) + (1,) * (fresh.dim() - 1)),
                        fresh, base)
    dst[idx] = write
    return dst


def seed_churn_state(state, static, params, *, per_tti_fading: bool = False,
                     active=None) -> EpisodeState:
    """Attach the churn leaves to a legacy :class:`EpisodeState`.

    ``active`` seeds the live-UE mask (default: every capacity slot live).
    The carried fading leaf is ``static.fad`` exactly when the engine
    carries it (Rayleigh fading on, per-TTI fading off), else ``None``.
    """
    if active is None:
        active = torch.ones(state.backlog.shape, dtype=torch.bool,
                            device=state.backlog.device)
    fad = (static.fad
           if params.rayleigh_fading and not per_tti_fading else None)
    return state._replace(active=active, fad=fad)


def seed_fault_state(state, n_cells: int = None,
                     cell_state=None) -> EpisodeState:
    """Attach the fault leaf to a legacy :class:`EpisodeState`: the per-cell
    codes ``cell_state`` (``sim.faults.UP``/``SLEEP``/``DOWN``), all-UP by
    default.  Needed only for a custom initial pattern: a fault-enabled
    engine starts a ``None`` leaf all-UP."""
    dev = state.backlog.device
    if cell_state is None:
        cell_state = sim_faults.init_cell_state(n_cells, dev)
    return state._replace(cell_state=torch.as_tensor(
        cell_state, dtype=torch.int32, device=dev))


def env_slice(tup, b):
    """Env ``b`` of a batched NamedTuple (views; ``None`` stays ``None``)."""
    return type(tup)(*(None if x is None else x[b] for x in tup))


def _restack(batched, outs, ins):
    """The batched leaf after a per-env pass: the input itself when every
    env returned its own input view (unchanged, or written in place),
    else the stack of the per-env results."""
    if all(o is i for o, i in zip(outs, ins)):
        return batched
    return None if outs[0] is None else torch.stack(outs)


def make_episode_fns(params, n_ues: int, n_cells: int,
                     radio_cfg: "radio.RadioConfig", traffic_step, *,
                     mobility_step_m=None, per_tti_fading: bool = False,
                     use_harq=None, radio_mode: str = "dense",
                     mobility_move_frac=None, inc_backend=None,
                     mesh=None, ue_axis=("ue",), cell_axis=None,
                     telemetry: bool = False, churn=None, relax=None,
                     faults=None) -> EpisodeFns:
    """Build the ``step``/``rollout`` functions for one configuration.

    ``traffic_step(gen)`` is the traffic model's arrival draw (``None`` for
    full buffer).  ``use_harq`` forces the HARQ state machine on or off
    (None = on iff ``harq_bler > 0``).  ``radio_mode="incremental"``
    carries a ``radio.RadioState`` and recomputes only the dirty rows per
    TTI; ``inc_backend`` routes that recompute: ``None``/``"torch"`` is
    ``radio.radio_update_rows``, ``"fused"`` is
    ``radio.radio_update_rows_fused`` (the CUDA kernel on CUDA tensors) and
    raises where the kernel cannot express the regime (handover tables,
    faults, non-stock sector patterns), and ``"auto"`` is ``"fused"``
    exactly when it can.

    ``churn`` (a ``sim.mobility.ChurnConfig``) makes the UE axis
    capacity-padded: ``state.active`` masks the live population, UEs
    depart and arrive every TTI (fresh positions and fading rows from the
    churn draws), and inactive slots are granted nothing.  In incremental
    mode the newborn rows join the mover rows in one index, so the fused
    backend stays at one kernel launch per TTI.  ``faults`` (a
    ``sim.faults.FaultConfig``) walks each cell's UP/SLEEP/DOWN chain per
    TTI and masks the tx power with it; the incremental path carries the
    gain matrices and re-derives every per-UE output when a cell changes
    state (``radio.radio_update_cells``, branch-free: no host read;
    under ``"auto"`` one pass of the ``reprice_cells`` kernel where the
    state carries no handover tables and the cells are not sharded).

    ``relax`` (a ``radio.RelaxConfig``) makes ``rollout`` differentiable
    with respect to a power ``action`` (or anything else the recomputed
    chain reads): soft attachment, the soft or straight-through CQI
    staircase and the soft max_cqi, each behind its flag, plus the
    autograd-traceable reductions of ``mac.scheduler`` and a 1e-6-bit
    ``served_bits`` floor.  ``relax=None`` is the legacy engine.  It takes
    the dense torch chain only: the fused kernel has no backward, so the
    incremental mode, churn, faults and a mesh raise.

    ``telemetry=True`` adds a per-TTI
    :class:`~repro_torch.obs.telemetry.Telemetry` to both functions'
    returns; it draws nothing and touches no state, so the trajectory is
    bit-identical either way.  Both functions take ``fairness_p=None``: a
    scalar overriding ``params.fairness_p`` in the PF weights for that
    call, its alpha-fair exponent computed in float32 as the reference
    computes a traced override.

    A batched state (leaves leading with B, see :class:`EpisodeFns`) runs
    each env's channel -- churn, faults, mobility and the radio chain,
    with that env's draws at its own TTI -- then the MAC of all B envs at
    once, through the flat-id segment reductions of ``mac.segments``.  The
    fused backend launches once per env and TTI.

    ``mesh`` (a ``core.distributed.Mesh``) shards the UE axis of every
    per-UE tensor over the ``ue_axis`` mesh axes (``n_ues`` must divide
    evenly); callers pass global tensors on every rank and get global
    tensors back.  ``cell_axis`` (requires ``mesh``) also shards the cell
    dimension of ``C``/``P``/``bore`` and the fading columns: attachment
    and A3 run through the cross-shard argmax and the serving row is an
    owning-shard gather, so attachment, serving cell and positions stay
    bitwise the single-device ones and the floats hold to 1e-5.  The
    fused kernel takes the dirty rows of a UE-only mesh, against all
    cells; under ``cell_axis`` it raises.  A mesh runs one env (no batch),
    without churn and without ``relax``.
    """
    churn_on = churn is not None
    faults_on = faults is not None
    if faults_on and relax is not None:
        raise ValueError(
            "faults= is incompatible with relax=: the outage tx mask is a "
            "hard discontinuity (a dark cell's RSRP column is exactly "
            "zero), so there is no useful gradient through a fault "
            "transition; differentiate a fault-free configuration instead")
    if churn_on and mesh is not None:
        raise ValueError(
            "episode_fns(mesh=..., churn=...) is unsupported: birth-death "
            "churn is single-host because newborn UEs scatter fresh "
            "position/fading rows into the capacity-padded active mask, "
            "and that scatter does not cross shard boundaries; drop mesh= "
            "or pass churn=None")
    if relax is not None:
        if mesh is not None:
            raise ValueError(
                "relax= (differentiable relaxations) is single-device: "
                "the soft allocator has no cross-shard reductions; drop "
                "mesh= (shrink the problem) or relax=None")
        if churn_on:
            raise ValueError(
                "relax= is incompatible with churn=: the birth-death "
                "scatter writes discrete rows (no gradient path through "
                "births); differentiate a fixed population instead")
        if radio_mode == "incremental":
            raise ValueError(
                "relax= requires radio_mode='dense': the incremental path "
                "carries hard argmax attachment in its RadioState and "
                "patches rows in place (and the fused kernel has no "
                "backward); pass radio_mode='dense' when differentiating")
    # -- mesh layout (None: one device) ------------------------------------
    if mesh is not None:
        if not isinstance(mesh, mesh_ops.Mesh):
            raise TypeError(f"mesh= must be a repro_torch.core.distributed."
                            f"Mesh; got {type(mesh).__name__}")
        ue_ax = mesh.axes(ue_axis)
        if n_ues % ue_ax.size:
            raise ValueError(
                f"n_ues={n_ues} must divide evenly over the {ue_ax.size} "
                f"shards of mesh axes {ue_ax.names}")
    else:
        ue_ax = None
        if cell_axis is not None:
            raise ValueError("cell_axis= requires mesh= (the cell dimension "
                             "shards over named mesh axes)")
    cell_ax = None if cell_axis is None else mesh.axes(cell_axis)
    if cell_ax is not None and set(cell_ax.names) & set(ue_ax.names):
        raise ValueError(f"ue_axis {ue_ax.names} and cell_axis "
                         f"{cell_ax.names} must name different mesh axes")
    if cell_ax is not None and n_cells % cell_ax.size:
        raise ValueError(
            f"n_cells={n_cells} must divide evenly over the {cell_ax.size} "
            f"shards of mesh axes {cell_ax.names}")
    n_loc = n_ues if ue_ax is None else n_ues // ue_ax.size
    m_loc = n_cells if cell_ax is None else n_cells // cell_ax.size
    row0 = 0 if ue_ax is None else ue_ax.index * n_loc   # first global row
    col0 = 0 if cell_ax is None else cell_ax.index * m_loc

    def local_rows(x):
        """This rank's block of a global-UE-axis tensor (every per-UE draw
        is taken at global shape, then sliced)."""
        return x if ue_ax is None else x[row0:row0 + n_loc]

    def local_cols(x, axis=1):
        """This rank's block of a global-cell-axis tensor."""
        return x if cell_ax is None else x.narrow(axis, col0, m_loc)

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
    # the fading factor is carried state exactly when newborns redraw
    # their rows into an otherwise static fading tensor
    fad_carried = churn_on and p.rayleigh_fading and not per_tti_fading
    if churn_on:
        max_birth = churn.max_arrivals_per_tti
        p_dep, lam = mobility.churn_rates(tti_s, churn)

    if inc_backend not in radio.BACKENDS:
        raise ValueError(f"inc_backend must be one of {radio.BACKENDS}; "
                         f"got {inc_backend!r}")
    inc_fused, reason = False, None
    if incremental:
        if ho_on:
            reason = ("handover regimes carry per-candidate-cell tables "
                      "(se_all) the streaming kernel never materialises")
        elif faults_on:
            reason = ("cell fault transitions re-derive per-UE outputs "
                      "from carried gain matrices (G) the streaming "
                      "kernel never materialises")
        elif cell_ax is not None:
            reason = ("the fused kernel's attachment argmax spans all "
                      "cells, but a cell-sharded shard holds only its "
                      "cell block")
        else:
            reason = radio.fused_unsupported_reason(cfg)
        if inc_backend == "fused" and reason is not None:
            raise ValueError(f"inc_backend='fused' cannot express this "
                             f"configuration: {reason}")
        inc_fused = inc_backend in ("auto", "fused") and reason is None

    def use_rs(power_act: bool) -> bool:
        """Does this specialisation run on a RadioState?  It is carried
        when mobility or churn dirties rows or faults change cells; a
        static-geometry power action's chain is computed once and held
        constant."""
        return incremental and (not static_geom or power_act or churn_on
                                or faults_on)

    def inc_fad(static):
        """The incremental chain's fading: ``None`` on the unfaded channel."""
        return static.fad if p.rayleigh_fading else None

    def init_rs(static, U, action, fad=None, pmul=None):
        P = static.P if action is None else action
        if pmul is not None:
            P = P * local_cols(pmul, axis=0)[:, None]
        f = fad if fad is not None else inc_fad(static)
        return radio.radio_init(cfg, U, static.C, static.bore, f, P,
                                with_tables=ho_on, with_gain=faults_on,
                                cell_axis=cell_ax)

    def walk_displacements(draws, t, U):
        """This TTI's per-row displacement + the window start (or None when
        every UE walks)."""
        if frac_on:
            start, d = draws.window(t, n_ues, n_move, mobility_step_m)
            rows = torch.arange(row0, row0 + n_loc, device=U.device)
            d_all, _ = mobility.window_displacements(start, d, rows, n_ues)
            return d_all, start
        return local_rows(draws.walk(t, n_ues, mobility_step_m)), None

    def inc_channel(static, rs, U, P, draws, t, fad, born_idx, n_born):
        """One incremental TTI of the radio chain: move, patch, read.
        The mover rows and the padded newborn rows go through one row
        recompute (each row's result depends only on its own position and
        fading row, so order and repeats do not matter).  Returns
        ``(U, rs, n_dirty)``: the number of genuinely dirty rows as an
        int32 scalar tensor, or the int 0 when nothing moves."""
        n_dirty, parts = 0, []
        if mobility_step_m is not None:
            d, start = walk_displacements(draws, t, U)
            U = mobility.apply_walk(U, d, p.extent_m)
            if start is None:
                parts.append(torch.arange(n_loc, dtype=torch.int32,
                                          device=U.device))
                n_dirty = n_loc
            else:
                # rows of the window outside this rank's block pad with
                # local row 0 (an idempotent recompute)
                idx, n_dirty = radio.window_indices(
                    start, n_move, n_ues, offset=row0, n_loc=n_loc)
                parts.append(idx)
        if born_idx is not None:
            parts.append(born_idx)
            n_dirty = n_dirty + n_born
        if parts:
            idx = parts[0] if len(parts) == 1 else torch.cat(parts)
            if inc_fused:
                rs = radio.radio_update_rows_fused(
                    cfg, rs, U, static.C, static.bore, fad, P, idx)
            else:
                rs = radio.radio_update_rows(cfg, rs, U, static.C,
                                             static.bore, fad, P, idx,
                                             cell_axis=cell_ax)
        return U, rs, n_dirty

    def sinr_chain(R, a, meas):
        """(se, cqi, a) for serving assignment ``a``.  Under
        ``relax.soft_attach`` the wanted/interference split is the softmax
        combination over the measurement ``meas`` the hard argmax ranks;
        the returned ``a`` stays the hard index either way."""
        if relax is not None and relax.soft_attach:
            gamma = radio.soft_attach_sinr(R, meas, relax.attach_tau,
                                           noise_w)
        else:
            gamma, _, _ = radio.sinr(R, a, noise_w, cell_ax)
        se, cqi = radio.se_chain_relaxed(cfg, gamma, relax)
        return se, cqi, a

    def gather_serving(se_all, cqi_all, a):
        return (radio.take_cell(se_all, a, cell_ax),
                radio.take_cell(cqi_all, a, cell_ax))

    def attach(R_like):
        return radio.attachment(R_like, cell_ax)

    def handover(a, ttt, meas_wb, born):
        """The A3 step on the wideband measurement ``meas_wb``; under churn
        the newborns (``born``) first attach to their best cell."""
        if churn_on:
            a = torch.where(born, torch.argmax(meas_wb, dim=1).to(a.dtype), a)
        return a3_handover(a, ttt, meas_wb, hyst_db, ttt_tti, cell_ax)

    def allocate(se, cqi, a, buf, avg, cursor, harq_pending, act, fair):
        demand = (buf[..., None] > 0.0) | harq_pending[..., None]
        if act is not None:
            # churn: inactive capacity slots are structurally idle
            demand = demand & act[..., None]
        active = demand & (se > 0.0)
        fp = p.fairness_p if fair is None else fair
        if relax is not None and relax.soft_sched and policy == "max_cqi":
            # winner-take-all softened to a softmax over the relaxed SE
            return mac_sched.allocate_max_cqi_soft(active, se, a, n_cells,
                                                   rb_chunk, relax.sched_tau)
        log_w = mac_sched.pf_log_weights_ewma(rb_bw * se, avg[..., None], fp)
        return mac_sched.allocate(policy, active, cqi, a, n_cells, rb_chunk,
                                  cursor, log_w, ue_ax)

    def harq_step(u, tb_new, hbits, hretx, granted):
        """One TTI of every UE's stop-and-wait process on the TTI's HARQ
        uniforms ``u``: pending UEs retransmit their stored TB when
        granted; fresh TBs enter the machine on failure and drop after
        ``max_retx`` retransmissions.  The fourth return is the TTI's
        ``(acks, nacks, retx, dropped_bits)`` telemetry tuple (None unless
        telemetry is on)."""
        pending = hbits > 0.0
        tb = torch.where(pending, hbits, tb_new)
        attempting = granted & (tb > 0.0)
        attempt = torch.where(pending, hretx, 0)
        p_fail = harq_fail_prob(bler, comb_db, attempt)
        ok = (u >= p_fail) & attempting
        fail = ~ok & attempting
        n_fail = attempt + 1
        keep = (fail & (n_fail <= max_retx)) | (pending & ~granted)
        delivered = torch.where(ok, tb, 0.0)
        stats = None
        if telemetry:
            i32 = torch.int32
            stats = (ok.sum(dim=-1).to(i32), fail.sum(dim=-1).to(i32),
                     (pending & attempting).sum(dim=-1).to(i32),
                     torch.where(fail & (n_fail > max_retx), tb,
                                 0.0).sum(dim=-1))
        hbits = torch.where(keep, tb, 0.0)
        hretx = torch.where(keep, torch.where(fail, n_fail, hretx), 0)
        return delivered, hbits, hretx.to(torch.int32), stats

    def prepare(static, U, power_act: bool):
        """Loop-invariant constants of the static-geometry regime."""
        h = {}
        if use_rs(power_act) or churn_on:
            # incremental: hoisted through the RadioState; churn: births
            # move rows, so nothing U-dependent is loop-invariant
            return h
        if static_geom and (per_tti_fading or ho_on or power_act
                            or faults_on):
            h["G"] = radio.pathgains(cfg, U, static.C, static.bore)
            if not power_act and not faults_on:
                R_mean = radio.rsrp(h["G"], static.P)
                h["R_mean"] = R_mean
                h["a"] = attach(R_mean) if attach_on_mean else None
                R_faded = radio.rsrp(radio.apply_fading(h["G"], static.fad),
                                     static.P)
                h["meas_wb"] = (R_mean if attach_on_mean
                                else R_faded).sum(dim=-1)
                if ho_on:
                    # static channel + evolving serving cell: tabulate the
                    # SINR chain for every candidate cell once
                    total = radio.cell_total(R_faded, cell_ax)
                    gamma_all = R_faded / (
                        noise_w + (total[:, None, :] - R_faded))
                    h["se_all"], h["cqi_all"] = radio.se_chain(cfg, gamma_all)
        return h

    def draw_fading(draws, t):
        """The TTI's fresh fading, drawn at global shape, then this rank's
        row and column block."""
        return local_cols(local_rows(draws.fading(t, cfg, n_ues, n_cells)))

    def channel(h, static, state, action, rs, draws, t: int):
        """One env's radio side of a TTI: churn, faults, mobility, the
        radio chain and the serving cell.  Returns ``(state, se, cqi,
        a_use, rs, n_dirty)``; ``state`` has its positions, churn-reset
        MAC leaves, serving cells, fault codes and churn leaves updated.
        ``t`` is the TTI as a Python int."""
        power_act = action is not None
        U, buf, avg = state.U, state.backlog, state.pf_avg
        hbits, hretx = state.harq_bits, state.harq_retx
        a_srv, ttt = state.serving, state.ttt
        n_dirty = 0 if incremental else None
        P = action if power_act else static.P
        # -- birth-death churn: departures idle out, newborns take free
        # slots with fresh positions and fading rows -----------------------
        act, fad_c, born, born_idx, n_born = state.active, state.fad, \
            None, None, None
        if churn_on:
            with annotate("crrm.churn"):
                act, born, n_born = mobility.birth_death_step(
                    draws.churn_birth(t, lam),
                    draws.churn_death(t, p_dep, n_ues), act, churn)
                # departed rows idle out; reborn slots then reset fresh (a
                # slot can depart and be re-occupied within one TTI)
                buf = torch.where(act, buf, 0.0)
                avg = torch.where(act, avg, 0.0)
                hbits = torch.where(act, hbits, 0.0)
                hretx = torch.where(act, hretx, 0)
                ttt = torch.where(act, ttt, 0)
                buf = torch.where(born, churn.newborn_backlog_bits, buf)
                avg = torch.where(born, 0.0, avg)
                hbits = torch.where(born, 0.0, hbits)
                hretx = torch.where(born, 0, hretx)
                ttt = torch.where(born, 0, ttt)
                born_idx = radio.dirty_indices(born, max_birth)
                U = scatter_born(U, born_idx, draws.churn_positions(
                    t, max_birth, p.extent_m, p.h_ut_m), n_born)
                if fad_carried:
                    fad_c = scatter_born(fad_c, born_idx, draws.churn_fading(
                        t, cfg, max_birth, n_cells), n_born)
        # -- cell faults: one Markov transition, then the per-cell tx mask
        cs, changed = state.cell_state, None
        if faults_on:
            with annotate("crrm.faults"):
                cs, changed = sim_faults.fault_step(
                    draws.fault_uniform(t, n_cells), cs, tti_s, faults)
                P = P * local_cols(sim_faults.tx_multiplier(cs, faults),
                                   axis=0)[:, None]
        # -- channel: incremental state, per-TTI recompute, or constants ---
        r = rs if rs is not None else h.get("rs")
        if r is not None:
            f_inc = fad_c if fad_carried else inc_fad(static)
            if rs is not None:              # carried: rows or cells change
                with annotate("crrm.radio"):
                    U, r, n_dirty = inc_channel(static, r, U, P, draws, t,
                                                f_inc, born_idx, n_born)
                    if faults_on:
                        # a transition re-prices every UE against the
                        # masked P from the carried gains (selected on
                        # any(changed)); "auto" in one kernel pass
                        r = radio.radio_update_cells(cfg, r, P, changed,
                                                     cell_axis=cell_ax,
                                                     backend=inc_backend)
                rs = r
            if ho_on:
                with annotate("crrm.handover"):
                    a_srv, ttt = handover(a_srv, ttt, r.meas, born)
                    a_use = a_srv
                    se, cqi = gather_serving(r.se_all, r.cqi_all, a_use)
            else:
                se, cqi, a_use = r.se, r.cqi, r.a
        elif mobility_step_m is not None or churn_on:
            # with churn alone the geometry still changes per TTI (births
            # move rows), so the full chain recomputes from the current U
            with annotate("crrm.radio"):
                if mobility_step_m is not None:
                    d, _ = walk_displacements(draws, t, U)
                    U = mobility.apply_walk(U, d, p.extent_m)
                G0 = radio.pathgains(cfg, U, static.C, static.bore)
                fad = (draw_fading(draws, t) if per_tti_fading
                       else (fad_c if fad_carried else static.fad))
                R = radio.rsrp(radio.apply_fading(G0, fad), P)
                R_meas = radio.rsrp(G0, P) if attach_on_mean else R
                a_inst = attach(R_meas)
        elif per_tti_fading or power_act or faults_on:
            with annotate("crrm.radio"):
                fad = (draw_fading(draws, t) if per_tti_fading
                       else static.fad)
                R = radio.rsrp(radio.apply_fading(h["G"], fad), P)
                if power_act or faults_on:
                    # the action / fault mask changes P: measurement and
                    # attachment recompute from the hoisted gain
                    R_meas = radio.rsrp(h["G"], P) if attach_on_mean else R
                    a_inst = attach(R_meas)
                else:
                    R_meas = h["R_mean"] if attach_on_mean else R
                    a_inst = h["a"] if attach_on_mean else attach(R)
        else:
            R = R_meas = a_inst = None   # fully static radio chain

        # -- serving cell: A3 carried state, or instantaneous argmax ------
        if r is None:
            if ho_on:
                meas_wb = (R_meas.sum(dim=-1) if R_meas is not None
                           else h["meas_wb"])
                with annotate("crrm.handover"):
                    a_srv, ttt = handover(a_srv, ttt, meas_wb, born)
                    a_use = a_srv
                    if R is None:
                        se, cqi = gather_serving(h["se_all"], h["cqi_all"],
                                                 a_use)
                if R is not None:
                    with annotate("crrm.radio"):
                        se, cqi, _ = sinr_chain(R, a_use, meas=meas_wb)
            elif R is not None:
                with annotate("crrm.radio"):
                    se, cqi, a_use = sinr_chain(R, a_inst,
                                                meas=R_meas.sum(dim=-1))
            else:
                se, cqi, a_use = static.se, static.cqi, static.a
        if faults_on and not ho_on:
            # track the attachment in the serving leaf, so outage-driven
            # reattachment is observable and survives step boundaries
            a_srv = a_use
        state = state._replace(U=U, backlog=buf, pf_avg=avg, harq_bits=hbits,
                               harq_retx=hretx, serving=a_srv, ttt=ttt,
                               active=act, fad=fad_c, cell_state=cs)
        return state, se, cqi, a_use, rs, n_dirty

    def mac(state, se, cqi, a_use, prev_srv, n_dirty, draw, fair):
        """The MAC side of a TTI -- traffic, grant, HARQ, drain -- for one
        env or a batch.  ``draw(f)`` is ``f(draws, t)`` for one env, the
        stack of the B envs' ``f(draws_b, t_b)`` for a batch.  Returns
        ``(state, tput, telemetry)``."""
        buf, avg = state.backlog, state.pf_avg
        hbits, hretx, act = state.harq_bits, state.harq_retx, state.active
        if traffic_step is not None:
            with annotate("crrm.traffic"):
                arrivals = local_rows(draw(
                    lambda d, t: d.traffic(t, traffic_step)))
                if churn_on:
                    arrivals = torch.where(act, arrivals, 0.0)
                buf = buf + arrivals
        with annotate("crrm.sched"):
            harq_pending = ((hbits > 0.0) if harq_on
                            else torch.zeros_like(buf, dtype=torch.bool))
            alloc = allocate(se, cqi, a_use, buf, avg, state.rr_cursor,
                             harq_pending, act, fair)
            drainable = torch.where(harq_pending, 0.0, buf)
            tb_new = mac_sched.served_bits(
                alloc, se, drainable, rb_bw, tti_s,
                floor=1e-6 if relax is not None else 1e-30).sum(dim=-1)
        with annotate("crrm.harq"):
            hstats = None
            if harq_on:
                u = local_rows(draw(lambda d, t: d.harq_uniform(t, n_ues)))
                bits, hbits, hretx, hstats = harq_step(
                    u, tb_new, hbits, hretx, alloc.sum(dim=-1) > 0.0)
            elif bler > 0.0:   # HARQ-lite: lost blocks stay queued -> retx
                ok = local_rows(draw(
                    lambda d, t: d.harq_bernoulli(t, 1.0 - bler, n_ues)))
                bits = tb_new * ok.to(tb_new.dtype)
            else:
                bits = tb_new
            # clamp: served_bits <= backlog only up to float rounding
            buf = torch.clamp(buf - (tb_new if harq_on else bits), min=0.0)
            tput = bits / tti_s
            avg = (1.0 - beta) * avg + beta * tput
            new = state._replace(backlog=buf, pf_avg=avg,
                                 rr_cursor=state.rr_cursor + rb_chunk,
                                 harq_bits=hbits, harq_retx=hretx,
                                 t=state.t + 1)
        telem = None
        if telemetry:
            with annotate("crrm.telemetry"):
                telem = step_telemetry(new, a_use, alloc, bits, tb_new, tput,
                                       hstats, prev_srv, n_dirty)
        return new, tput, telem

    def step_telemetry(state, a_use, alloc, bits, tb_new, tput, hstats,
                       prev_srv, n_dirty):
        """The TTI's KPIs, only from values the step computed."""
        i32, buf = torch.int32, state.backlog
        count = lambda m: m.sum(dim=-1).to(i32)
        zero = lambda: torch.zeros(buf.shape[:-1], dtype=i32,
                                   device=buf.device)
        if hstats is None:
            acks = count(bits > 0.0)
            nacks = (count((tb_new > 0.0) & (bits == 0.0))
                     if bler > 0.0 else zero())
            hstats = (acks, nacks, zero(),
                      torch.zeros(buf.shape[:-1], dtype=torch.float32,
                                  device=buf.device))
        a_srv = state.serving
        ho_fired = count(a_srv != prev_srv) if ho_on else zero()
        if isinstance(n_dirty, int):
            n_dirty = torch.full(buf.shape[:-1], n_dirty, dtype=i32,
                                 device=buf.device)
        return obs_telemetry.tti_telemetry(
            n_cells, n_ues, a_use, alloc, bits, tput, buf, hstats, ho_fired,
            n_dirty, ue_ax,
            active_count=count(state.active) if churn_on else None,
            cells_down=(count(state.cell_state == sim_faults.DOWN)
                        if faults_on else None),
            reattached=count(a_srv != prev_srv) if faults_on else None)

    def tti_step(h, static, state, action, rs, draws, t: int, fair):
        """One TTI of one env: (state, tput, radio-state, telemetry)."""
        with annotate("crrm.tti"):
            prev_srv = state.serving
            state, se, cqi, a_use, rs, n_dirty = channel(
                h, static, state, action, rs, draws, t)
            state, tput, telem = mac(state, se, cqi, a_use, prev_srv,
                                     n_dirty, lambda f: f(draws, t), fair)
        return state, tput, rs, telem

    def batch_tti(hs, static, state, action, rss, draws, ts, fair):
        """One TTI of a batch: each env's channel, then one batched MAC."""
        ins = [env_slice(state, b) for b in range(len(ts))]
        outs = [channel(hs[b], env_static(static, b), ins[b],
                        env_action(action, b), rss[b], draws[b], t)
                for b, t in enumerate(ts)]
        new = type(state)(*(
            _restack(x, [o[0][i] for o in outs], [s[i] for s in ins])
            for i, x in enumerate(state)))
        i32, dev = torch.int32, state.backlog.device
        n_dirty = None
        if incremental:
            n_dirty = torch.stack([torch.as_tensor(o[5], dtype=i32,
                                                   device=dev)
                                   for o in outs])
        stack = lambda k: torch.stack([o[k] for o in outs])
        new, tput, telem = mac(
            new, stack(1), stack(2), stack(3), state.serving, n_dirty,
            lambda f: torch.stack([f(d, t) for d, t in zip(draws, ts)]),
            fair)
        return new, tput, [o[4] for o in outs], telem

    def env_static(static, b):
        return static if static.a.dim() == 1 else env_slice(static, b)

    def env_action(action, b):
        return action if action is None or action.dim() == 2 else action[b]

    def setup(static, state, action):
        """(hoisted constants, carried RadioState) for one specialisation."""
        with annotate("crrm.radio_init"):
            power_act = action is not None
            h = prepare(static, state.U, power_act)
            rs0 = None
            if use_rs(power_act):
                if static_geom and not churn_on and not faults_on:
                    # a static-geometry power action: computed once, held
                    h["rs"] = init_rs(static, state.U, action)
                else:
                    pmul0 = (sim_faults.tx_multiplier(state.cell_state, faults)
                             if faults_on else None)
                    rs0 = init_rs(static, state.U, action,
                                  fad=state.fad if fad_carried else None,
                                  pmul=pmul0)
            return h, rs0

    def start(state):
        """The state a step or rollout runs on: the fault leaf seeded
        all-UP when absent, and the leaves that churn writes in place
        (positions, carried fading) copied, so the caller's stay intact."""
        if faults_on and state.cell_state is None:
            state = state._replace(cell_state=torch.zeros(
                state.t.shape + (n_cells,), dtype=torch.int32,
                device=state.backlog.device))
        if churn_on:
            state = state._replace(
                U=state.U.clone(),
                fad=None if state.fad is None else state.fad.clone())
        return state

    def fairness(fairness_p, device):
        """The override as a float32 tensor (None stays None)."""
        if fairness_p is None:
            return None
        return torch.as_tensor(fairness_p, dtype=torch.float32,
                               device=device)

    def roll(static, state, n_tti, draws, action, fair):
        """Roll one env ``n_tti`` TTIs: (state, [tput], [telem])."""
        tputs, telems = [], []
        h, rs = setup(static, state, action)
        t0 = int(state.t)              # the one host read, before the loop
        for t in range(t0, t0 + n_tti):
            state, tput, rs, telem = tti_step(h, static, state, action, rs,
                                              draws, t, fair)
            tputs.append(tput)
            telems.append(telem)
        return state, tputs, telems

    if mesh is not None:
        # which dimensions of each leaf shard over which mesh axes
        ue_axes = ue_ax.names
        cell_axes = None if cell_ax is None else cell_ax.names
        ue = mesh_ops.P(ue_axes)
        static_specs = EpisodeStatic(
            se=ue, cqi=ue, a=ue, C=mesh_ops.P(cell_axes),
            P=mesh_ops.P(cell_axes), bore=mesh_ops.P(cell_axes),
            fad=mesh_ops.P(ue_axes, cell_axes))
        state_specs = EpisodeState(
            U=ue, backlog=ue, pf_avg=ue, rr_cursor=mesh_ops.P(),
            harq_bits=ue, harq_retx=ue, serving=ue, ttt=ue,
            t=mesh_ops.P(), seed=mesh_ops.P(),
            cell_state=mesh_ops.P(None) if faults_on else None)

    def run_mesh(static, state, n_tti, draws, action, fair):
        """:func:`roll` on this rank's block of the global inputs; the
        outputs reassembled to global ones on every rank."""
        if state.t.dim():
            raise ValueError(
                "a mesh runs one env: its UE-sharded program already spans "
                "the ranks; batch over seeds or shard over UEs, not both")
        if state.backlog.device.type != mesh.device.type:
            raise ValueError(f"the mesh computes on {mesh.device}; the "
                             f"state is on {state.backlog.device}")
        block = lambda tup, specs: type(tup)(*(
            x if x is None or sp is None else mesh.block(x, sp)
            for x, sp in zip(tup, specs)))
        if action is not None:
            action = local_cols(action, axis=0).contiguous()
        state, tputs, telems = roll(block(static, static_specs),
                                    block(state, state_specs), n_tti, draws,
                                    action, fair)
        # the replicated slots: every rank must have counted alike
        mesh_ops.check_replicated(
            (state.rr_cursor, state.t, state.seed, state.cell_state), mesh,
            "episode state")
        state = type(state)(*(x if x is None or sp is None
                              else mesh.unblock(x, sp)
                              for x, sp in zip(state, state_specs)))
        tput = mesh.unblock(torch.stack(tputs), mesh_ops.P(None, ue_axes))
        return state, list(tput.unbind(0)), telems

    def run(static, state, n_tti, draws, action, fairness_p):
        """Roll ``n_tti`` TTIs: (state, [tput], [telem]) per TTI."""
        state = start(state)
        fair = fairness(fairness_p, state.backlog.device)
        if mesh is not None:
            return run_mesh(static, state, n_tti, draws, action, fair)
        if state.t.dim() == 0:
            return roll(static, state, n_tti, draws, action, fair)
        tputs, telems = [], []
        n_env = state.t.shape[0]
        if len(draws) != n_env:
            raise ValueError(f"a batch of {n_env} envs needs {n_env} draws; "
                             f"got {len(draws)}")
        hs, rss = zip(*(setup(env_static(static, b), env_slice(state, b),
                              env_action(action, b)) for b in range(n_env)))
        rss = list(rss)
        t0 = state.t.tolist()          # the one host read, before the loop
        for i in range(n_tti):
            with annotate("crrm.tti"):
                state, tput, rss, telem = batch_tti(
                    hs, static, state, action, rss, draws,
                    [t + i for t in t0], fair)
            tputs.append(tput)
            telems.append(telem)
        return state, tputs, telems

    def step(static, state, draws, action=None, fairness_p=None):
        with annotate("crrm.rollout"):
            state, (tput,), (telem,) = run(static, state, 1, draws, action,
                                           fairness_p)
        return (state, tput, telem) if telemetry else (state, tput)

    def rollout(static, state, n_tti, draws, action=None, fairness_p=None):
        with annotate("crrm.rollout"):
            state, tputs, telems = run(static, state, n_tti, draws, action,
                                       fairness_p)
            axis = state.t.dim()           # 0, or 1 after a batch axis
            tput = torch.stack(tputs, dim=axis)
            if telemetry:
                return state, tput, obs_telemetry.stack(telems, dim=axis)
        return state, tput

    return EpisodeFns(step=step, rollout=rollout,
                      inc_backend=(("fused" if inc_fused else "torch")
                                   if incremental else None),
                      inc_reason=reason)


def episode_fns_for(sim, *, mobility_step_m=None, per_tti_fading=False,
                    use_harq=None, mesh=None, ue_axis=("ue",),
                    cell_axis=None, radio_mode=None, mobility_move_frac=None,
                    inc_backend=None, telemetry: bool = False, churn=None,
                    relax=None, faults=None) -> EpisodeFns:
    """The :func:`make_episode_fns` bundle for ``sim``, cached on it.

    ``mobility_step_m=None`` falls back to ``params.mobility_step_m``
    (``0`` forces static geometry); ``radio_mode``,
    ``mobility_move_frac`` and ``faults`` fall back to their
    ``CRRM_parameters`` fields (``faults=0`` forces the fault process off).
    """
    if mobility_step_m is None:
        mobility_step_m = sim.params.mobility_step_m
    if not mobility_step_m:          # 0 / None -> static geometry
        mobility_step_m = None
    if radio_mode is None:
        radio_mode = sim.params.radio_mode
    if mobility_move_frac is None:
        mobility_move_frac = sim.params.mobility_move_frac
    if faults is None:
        faults = sim.params.faults
    if not faults:                   # 0 / False -> fault-free program
        faults = None
    ue_axis = mesh_ops._names(ue_axis)
    if cell_axis is not None:
        cell_axis = mesh_ops._names(cell_axis)
    cache_key = (mobility_step_m, per_tti_fading, use_harq, mesh, ue_axis,
                 cell_axis, radio_mode, mobility_move_frac, inc_backend,
                 bool(telemetry), churn, relax, faults)
    cache = sim.__dict__.setdefault("_episode_fns_cache", {})
    if cache_key not in cache:
        cache[cache_key] = make_episode_fns(
            sim.params, sim.n_ues, sim.n_cells, sim.radio_config(),
            sim._traffic_step, mobility_step_m=mobility_step_m,
            per_tti_fading=per_tti_fading, use_harq=use_harq, mesh=mesh,
            ue_axis=ue_axis, cell_axis=cell_axis, radio_mode=radio_mode,
            mobility_move_frac=mobility_move_frac, inc_backend=inc_backend,
            telemetry=bool(telemetry), churn=churn, relax=relax,
            faults=faults)
    return cache[cache_key]


def run_episode(sim, n_tti: int, draws=None, mobility_step_m=None,
                per_tti_fading: bool = False, sync_state: bool = True,
                use_harq=None, mesh=None, radio_mode=None,
                mobility_move_frac=None, inc_backend=None,
                telemetry: bool = False, churn=None, faults=None):
    """Run ``n_tti`` TTIs; returns (n_tti, n_ues) delivered throughput
    (bits/s), or ``(tput, telem)`` with ``telemetry=True``.  ``draws``
    defaults to ``Draws(params.seed, sim.device)``; ``sync_state`` writes
    the final state back into the graph.  Under ``churn`` the episode
    starts with every capacity slot live (:func:`seed_churn_state`).
    ``mesh`` runs the rollout sharded over the UE axis (``("ue",)``)."""
    fns = episode_fns_for(sim, mobility_step_m=mobility_step_m,
                          per_tti_fading=per_tti_fading, use_harq=use_harq,
                          mesh=mesh, radio_mode=radio_mode,
                          mobility_move_frac=mobility_move_frac,
                          inc_backend=inc_backend, telemetry=telemetry,
                          churn=churn, faults=faults)
    if draws is None:
        draws = Draws(sim.params.seed, sim.device)
    static, state = sim.episode_static(), sim.init_episode_state()
    if churn is not None:
        state = seed_churn_state(state, static, sim.params,
                                 per_tti_fading=per_tti_fading)
    state, tput, *telem = fns.rollout(static, state, n_tti, draws)
    if mobility_step_m is None:
        mobility_step_m = sim.params.mobility_step_m
    if sync_state:
        sim.sync_episode_state(state, positions=bool(mobility_step_m))
    return (tput, telem[0]) if telemetry else tput
