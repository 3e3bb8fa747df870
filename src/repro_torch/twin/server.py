"""The digital-twin simulation server: continuous runs, served in chunks.

The port of ``repro.twin.server``.  A network digital twin is not an
episode: it runs for as long as the live network it mirrors, takes control
updates while running, and must survive the death of its process without
losing or perturbing its trajectory.  :class:`TwinServer` does that over
the episode engine (``repro_torch.mac.engine``):

* **Chunked stepping** -- one ``rollout`` of ``chunk_tti`` TTIs per call,
  ``fns.rollout(static, state, chunk_tti, draws, action=power,
  fairness_p=fairness)``.  Every draw is keyed on the episode seed (the
  state's ``seed`` leaf) and the absolute TTI, so chunks continue one
  trajectory.
* **Birth-death churn** -- the engine's capacity-padded ``active`` mask
  (``sim.mobility.ChurnConfig``): UEs arrive and depart inside the chunk.
* **Live control** -- the per-cell power grid and the PF fairness
  exponent are tensors passed to every chunk, so :meth:`set_power` and
  :meth:`set_fairness` take effect at the next chunk boundary and never
  rebuild :attr:`fns`.
* **Checkpoint/restore** -- ``train.checkpoint`` (atomic, keep-k,
  optionally async) snapshots the full serving tuple ``{"state", "power",
  "fairness"}``: the episode state with its seed, TTI counter, churn leaves
  (``active``, ``fad``) and fault codes (``cell_state``), and the live
  controls.
* **Fault injection** -- ``faults=sim.faults.FaultConfig(...)`` (or a
  preset that bakes one in, e.g. ``outage_storm``) walks every cell
  through its outage/sleep chain inside the chunk; the KPI summaries then
  carry ``mean_cells_down`` and ``reattach_events``.
* **Self-healing** -- ``watchdog=WatchdogConfig(...)`` (or ``True``) makes
  :meth:`step_chunk` a guarded loop: each chunk runs under an optional
  wall-clock timeout, the carry is checked by ``robust.guard.carry_ok``,
  and success checkpoints on a cadence.  On NaN, exception or timeout the
  server rolls back to the newest checkpoint that validates, sleeps an
  exponential backoff and retries on the **same** ``inc_backend``: there
  is no degradation ladder (the reference rebuilds on ``xla`` after any
  exception under a fused backend, which would hide a failing kernel).
  Every failure goes into :attr:`fault_history`; ``max_retries``
  consecutive failures, or a rollback that fails (a poisoned CUDA context
  fails the restore too), stop the server with ``TwinServerDown``, whose
  history names the route.  A timed-out chunk is abandoned on its thread
  and fenced off by generation: its late result never commits.
* **Ownership** -- the server clones the initial state's leaves (the
  simulator's ``init_episode_state`` hands out the graph's own ``U`` and
  backlog), so nothing it serves, injects or restores writes into
  ``sim``'s tensors.

Contracts.  On the CPU a restored server and an uninterrupted one agree
bit for bit, and so do N chunks of M TTIs and one N*M-TTI run.  On a card,
restore-resume is bitwise in PyTorch's deterministic mode
(``torch.use_deterministic_algorithms(True)``: ``index_add_``, the
per-cell segment sum, otherwise adds with atomics in no fixed order); a
restored server restarts at the same chunk boundaries as the
uninterrupted one.  Chunk partitions under ``inc_backend="fused"`` on a
card agree only to the parity contract (attachment exact off near ties,
CQI exact off staircase steps, floats to rtol 1e-4): every chunk rebuilds
the ``RadioState`` with the torch chain, while inside a chunk the dirty
rows go through the kernel, which agrees with the torch chain to ~1e-6
relative.

Spans: each chunk runs inside ``crrm.twin.chunk``, its KPI summary, the
guard, a checkpoint and a restore inside ``crrm.twin.summary``,
``crrm.twin.guard``, ``crrm.twin.checkpoint`` and ``crrm.twin.restore``
(``repro_torch.obs.profile.SPANS``).

    python -m repro_torch.twin.server --smoke [--device cpu]
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.mac.engine import Draws, seed_churn_state, seed_fault_state
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.profile import annotate
from repro_torch.robust import guard as robust_guard
from repro_torch.robust.watchdog import (GuardViolation, TwinServerDown,
                                         WatchdogConfig, run_with_timeout)
from repro_torch.sim.mobility import ChurnConfig
from repro_torch.train import checkpoint as ckpt


def _owned(tup):
    """A NamedTuple of fresh copies of ``tup``'s tensors."""
    return type(tup)(*(None if x is None else x.clone() for x in tup))


class TwinServer:
    """A continuously running simulation twin, stepped in chunks.

    ``sim`` is a built ``CRRM``; ``churn`` the birth-death process (its
    ``max_arrivals_per_tti`` is also the per-TTI newborn row budget).
    ``chunk_tti`` sets the serving granularity: KPI summaries stream once
    per chunk and control updates land at chunk boundaries.  ``ckpt_dir``
    enables :meth:`checkpoint` / :meth:`restore`.

    ``seed`` is the episode seed (default ``params.seed``) and
    ``draws(seed, device) -> Draws`` makes the chunk's draws from it
    (default :class:`~repro_torch.mac.engine.Draws`; the factory
    ``CrrmEnv`` takes).  ``faults`` arms the per-cell fault process
    (default the scenario's ``params.faults``; ``0`` forces it off).
    ``inc_backend`` routes the incremental radio mode's dirty rows as in
    ``episode_fns``, and stays the route through every recovery.
    ``watchdog`` (a :class:`~repro_torch.robust.watchdog.WatchdogConfig`,
    or ``True`` for the defaults) turns :meth:`step_chunk` into the guarded
    loop; it requires ``ckpt_dir`` and writes a checkpoint at t = 0.
    """

    def __init__(self, sim, churn: ChurnConfig, *, chunk_tti: int = 100,
                 ckpt_dir=None, keep_last: int = 3,
                 per_tti_fading: bool = False, radio_mode=None, seed=None,
                 faults=None, inc_backend=None, watchdog=None, draws=None):
        self.sim, self.churn, self.chunk_tti = sim, churn, int(chunk_tti)
        self.ckpt_dir, self.keep_last = ckpt_dir, keep_last
        if faults is None:
            faults = sim.params.faults
        self.faults = faults or None
        self.inc_backend = inc_backend
        self.fns = sim.episode_fns(per_tti_fading=per_tti_fading,
                                   radio_mode=radio_mode, telemetry=True,
                                   churn=churn, faults=faults,
                                   inc_backend=inc_backend)
        self._draws = draws or Draws
        self.static = sim.episode_static()
        state = seed_churn_state(sim.init_episode_state(seed), self.static,
                                 sim.params, per_tti_fading=per_tti_fading)
        if self.faults is not None:
            # seed the fault leaf now, so every checkpoint of this server
            # has one tree structure (restore reads the structure)
            state = seed_fault_state(state, sim.n_cells)
        self.state = _owned(state)
        # the live controls, passed to every chunk: updating one swaps a
        # tensor, never the episode functions
        self.power = self.static.P.clone()
        self.fairness = torch.tensor(sim.params.fairness_p,
                                     dtype=torch.float32, device=sim.device)
        self.last_tput = self.last_telem = None

        if watchdog is True:
            watchdog = WatchdogConfig()
        self.watchdog = watchdog
        self.fault_history: list = []
        self._chunks_since_ckpt = 0
        # bumped by every rollback/restore: a timed-out chunk abandoned on
        # its worker thread must never commit a result computed from the
        # state before the rollback
        self._gen = 0
        self._commit = threading.Lock()
        if watchdog is not None:
            if ckpt_dir is None:
                raise ValueError("watchdog requires ckpt_dir: rollback "
                                 "needs a checkpoint to roll back to")
            self.checkpoint()            # the t=0 rollback target

    # ------------------------------------------------------------- stepping
    @property
    def t(self) -> int:
        """The absolute TTI counter (keys every per-TTI draw)."""
        return int(self.state.t)

    def _chunk(self, static, state, power, fairness):
        """One chunk of the engine: ``(state, tput, telemetry)``."""
        draws = self._draws(int(state.seed), self.sim.device)
        return self.fns.rollout(static, state, self.chunk_tti, draws,
                                action=power, fairness_p=fairness)

    def step_chunk(self) -> dict:
        """Advance ``chunk_tti`` TTIs; return the chunk's KPI summary.

        The summary is ``obs.telemetry.summarize`` over the chunk's per-TTI
        telemetry plus the serving counters ``t`` and ``active_ues``: plain
        host data, what a dashboard or calibration loop consumes.  The
        chunk's throughput and telemetry stay in :attr:`last_tput` and
        :attr:`last_telem`.  With a ``watchdog`` armed this is the guarded
        loop (module docstring).
        """
        with annotate("crrm.twin.chunk"):
            if self.watchdog is None:
                return self._step_chunk_raw()
            return self._step_chunk_guarded()

    def _step_chunk_raw(self) -> dict:
        gen = self._gen
        state, tput, telem = self._chunk(self.static, self.state,
                                         self.power, self.fairness)
        with annotate("crrm.twin.summary"):
            kpis = obs_telemetry.summarize(telem,
                                           tti_s=self.sim.params.tti_s)
            kpis["t"] = float(state.t)
            kpis["active_ues"] = float(state.active.sum())
        with self._commit:
            if gen != self._gen:
                # a rollback superseded this attempt while it ran (it timed
                # out and was abandoned): its result must not replace the
                # restored state the retry serves from
                raise RuntimeError("stale chunk result discarded "
                                   "(superseded by a rollback)")
            self.state = state
            self.last_tput, self.last_telem = tput, telem
        return kpis

    def _step_chunk_guarded(self) -> dict:
        wd = self.watchdog
        delay = wd.backoff_s
        for attempt in range(wd.max_retries + 1):
            try:
                kpis = run_with_timeout(self._step_chunk_raw,
                                        wd.chunk_timeout_s)
                with annotate("crrm.twin.guard"):
                    if not robust_guard.carry_ok(self.state):
                        raise GuardViolation(
                            "carry invariants violated after chunk: "
                            + "; ".join(
                                robust_guard.carry_violations(self.state)
                                or ["(guard tripped, no host detail)"]))
            except Exception as e:  # noqa: BLE001 -- the watchdog's job
                self.fault_history.append(
                    f"attempt {attempt} on inc_backend={self.inc_backend!r}:"
                    f" {type(e).__name__}: {e}")
                step = self._recover()
                if attempt < wd.max_retries:
                    time.sleep(delay)
                    delay *= wd.backoff_factor
            else:
                self._chunks_since_ckpt += 1
                if self._chunks_since_ckpt >= wd.ckpt_every_chunks:
                    self.checkpoint()
                    self._chunks_since_ckpt = 0
                return kpis
        raise TwinServerDown(
            f"{wd.max_retries + 1} consecutive chunk attempts failed at "
            f"t={step} on inc_backend={self.inc_backend!r}; stopping "
            "gracefully", history=self.fault_history)

    def _recover(self) -> int:
        """Roll back after a failed attempt; a rollback that fails too (no
        valid checkpoint, or a device context an illegal access poisoned)
        stops the server."""
        try:
            step = self.restore()        # the newest valid checkpoint
        except Exception as e:  # noqa: BLE001 -- ends in a graceful stop
            self.fault_history.append(
                f"rollback failed: {type(e).__name__}: {e}")
            raise TwinServerDown(
                f"rollback failed on inc_backend={self.inc_backend!r}; "
                "stopping gracefully", history=self.fault_history) from e
        self.fault_history.append(f"rolled back to t={step}")
        return step

    def serve(self, n_chunks: int):
        """Generator: stream ``n_chunks`` KPI summaries, one per chunk."""
        for _ in range(n_chunks):
            yield self.step_chunk()

    # ------------------------------------------------------- live controls
    def set_power(self, P) -> None:
        """Swap the (n_cells, n_freq) tx power grid; the next chunk uses
        it.  A tensor swap: :attr:`fns` is not rebuilt."""
        self.power = torch.as_tensor(P, dtype=torch.float32,
                                     device=self.sim.device).clone()

    def set_fairness(self, p) -> None:
        """Swap the PF fairness exponent ``p``; the next chunk uses it."""
        self.fairness = torch.tensor(float(p), dtype=torch.float32,
                                     device=self.sim.device)

    # -------------------------------------------------- checkpoint/restore
    def _tree(self) -> dict:
        """The full serving tuple: state and live controls."""
        return {"state": self.state, "power": self.power,
                "fairness": self.fairness}

    def checkpoint(self, block: bool = True):
        """Snapshot the serving tuple at the current TTI (atomic, keep-k).

        Returns the step; ``block=False`` copies the leaves to host memory
        now (so later chunks cannot change what is written) and writes the
        directory on a daemon thread, which it returns for joining.
        """
        if self.ckpt_dir is None:
            raise ValueError("TwinServer built without ckpt_dir")
        with annotate("crrm.twin.checkpoint"):
            step = self.t
            extra = {"chunk_tti": self.chunk_tti}
            if block:
                ckpt.save(self.ckpt_dir, step, self._tree(),
                          keep_last=self.keep_last, extra=extra)
                return step
            return ckpt.save_async(self.ckpt_dir, step, self._tree(),
                                   keep_last=self.keep_last, extra=extra)

    def restore(self, step=None) -> int:
        """Rewind to a checkpointed TTI (default: the newest valid one).

        Restores state *and* controls, so the resumed trajectory is the
        uninterrupted one, control updates live at checkpoint time
        included.  Only the current tree's structure, dtypes and devices
        are read.  With ``step=None`` a corrupt or truncated latest step
        falls back to the previous valid one; an explicit ``step`` raises
        ``CheckpointCorrupt`` if that step fails validation.
        """
        if self.ckpt_dir is None:
            raise ValueError("TwinServer built without ckpt_dir")
        with self._commit:
            # fence first: no chunk abandoned before this commits after it
            self._gen += 1
        with annotate("crrm.twin.restore"):
            if step is None:
                tree, _, step = ckpt.restore_latest_valid(self.ckpt_dir,
                                                          self._tree())
            else:
                tree, _ = ckpt.restore(self.ckpt_dir, step, self._tree())
        self.state, self.power = tree["state"], tree["power"]
        self.fairness = tree["fairness"]
        self._chunks_since_ckpt = 0
        return step


def _smoke(tmpdir: str, device=None, n_ues: int = 96, n_cells: int = 7,
           chunk: int = 25) -> None:
    """Arrivals happen, and one kill/restore cycle resumes bit for bit."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters

    sim = CRRM(CRRM_parameters(
        n_ues=n_ues, n_cells=n_cells, n_sectors=1, seed=7,
        pathloss_model_name="UMa", power_W=10.0, traffic_model="poisson",
        scheduler_policy="pf",
        traffic_params=dict(arrival_rate_hz=300.0,
                            packet_size_bits=12_000.0)), device=device)
    churn = ChurnConfig(arrival_rate_hz=400.0, mean_lifetime_s=0.15,
                        max_arrivals_per_tti=8)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        srv = TwinServer(sim, churn, chunk_tti=chunk, ckpt_dir=tmpdir)
        k1 = srv.step_chunk()
        srv.set_power(srv.power * 1.1)               # live control update
        srv.checkpoint()
        k2 = srv.step_chunk()
        tail, final = srv.last_tput, srv.state

        srv.restore()                                # "kill" + resume
        k2b = srv.step_chunk()
    finally:
        torch.use_deterministic_algorithms(deterministic)

    if not k1["mean_active_ues"] < n_ues:
        raise AssertionError("no departures ever happened")
    if not k1["served_mbits"] > 0.0:
        raise AssertionError("nothing was served")
    if not torch.equal(tail, srv.last_tput):
        raise AssertionError("restored throughput diverged")
    for name, a, b in zip(final._fields, final, srv.state):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"restored state leaf {name} diverged")
    if k2 != k2b:
        raise AssertionError("restored KPI summary diverged")
    print("twin smoke OK on %s: t=%d active=%d served=%.3f Mbit" % (
        sim.device, int(final.t), int(final.active.sum()),
        k2["served_mbits"]))


def main(argv=None) -> None:
    """CLI: run a twin server and stream KPI lines (or the smoke check)."""
    import argparse
    import tempfile

    from repro_torch.obs.telemetry import format_summary

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scenario, one restore cycle, bitwise resume "
                         "assertion")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ues", type=int, default=1000)
    ap.add_argument("--cells", type=int, default=19)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--chunks", type=int, default=10)
    ap.add_argument("--arrival-hz", type=float, default=2000.0)
    ap.add_argument("--lifetime-s", type=float, default=0.4)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    if args.smoke:
        with tempfile.TemporaryDirectory() as td:
            _smoke(td, device=args.device)
        return

    from repro_torch.core.crrm import CRRM
    from repro_torch.core.params import CRRM_parameters

    sim = CRRM(CRRM_parameters(
        n_ues=args.ues, n_cells=args.cells, n_sectors=1, seed=0,
        pathloss_model_name="UMa", power_W=10.0, traffic_model="poisson",
        scheduler_policy="pf",
        traffic_params=dict(arrival_rate_hz=300.0,
                            packet_size_bits=12_000.0)), device=args.device)
    churn = ChurnConfig(
        arrival_rate_hz=args.arrival_hz, mean_lifetime_s=args.lifetime_s,
        max_arrivals_per_tti=max(
            4, int(4 * args.arrival_hz * sim.params.tti_s)))
    srv = TwinServer(sim, churn, chunk_tti=args.chunk,
                     ckpt_dir=args.ckpt_dir)
    for i, kpis in enumerate(srv.serve(args.chunks)):
        print(f"chunk {i} (t={int(kpis.pop('t'))}):")
        print(format_summary(kpis))


if __name__ == "__main__":
    main()
