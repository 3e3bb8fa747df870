"""Chaos drill: prove the twin survives the failures we can script.

Recovery code that is never exercised is recovery code that does not
work.  This module is the scripted drill (``python -m
repro_torch.robust.chaos --smoke [--device cpu]``): a
:class:`~repro_torch.twin.server.TwinServer` under the ``outage_storm``
cell fault process and an armed watchdog meets, in order,

1. **a poisoned carry** -- NaN written into the serving state's positions
   between chunks, out of place (the guard must trip, the watchdog must
   roll back, and the retry must reach the next chunk boundary);
2. **a crashing chunk** -- the chunk replaced by one that raises once (the
   forced kernel failure: recovery retries on the route the server was
   built with, which stays unchanged);
3. **a corrupted latest checkpoint** -- bytes flipped in the newest step's
   first leaf file (the rollback must fall through to the previous valid
   step, not resurrect garbage).

The drill asserts that the server recovers from all three on its own
``inc_backend``, that the final KPI summary is finite and that the failure
history recorded every injected fault; each recovery's wall time is
printed in healthy chunks.  Exit code 0 and the ``CHAOS_OK`` line are the
contract.
"""
from __future__ import annotations

import math
import os
import tempfile
import time

from repro_torch.robust.watchdog import WatchdogConfig
from repro_torch.train import checkpoint as ckpt


def _corrupt_latest(ckpt_dir: str) -> int:
    """Flip bytes in the newest step's first leaf; return that step."""
    step = ckpt.latest_step(ckpt_dir)
    leaf = os.path.join(ckpt_dir, f"step_{step:010d}", "00000.npy")
    with open(leaf, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)
    return step


def _poison(srv) -> None:
    """NaN into every UE's x position, out of place: mobility is an
    additive walk, so it survives the chunk, and every row is hit, so
    newborns (which redraw a slot's position) cannot heal it."""
    U = srv.state.U.clone()
    U[:, 0] = float("nan")
    srv.state = srv.state._replace(U=U)


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(f"chaos drill: {what}")


def _finite(kpis: dict) -> bool:
    return all(math.isfinite(v) for v in kpis.values())


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def drill(ckpt_dir: str, n_ues: int = 64, n_cells: int = 7,
          chunk: int = 20, verbose: bool = True, device=None,
          radio_mode=None, inc_backend=None) -> dict:
    """Run the injection sequence; return the final KPI summary.

    Checks as it goes -- an exception means the drill failed.  Small by
    default; the injections scale with nothing, so a larger twin (more
    UEs, ``radio_mode="incremental"``, ``inc_backend="auto"``) drills the
    same way.  The recovery times are in the returned dict's ``recovery``
    entry, seconds and healthy chunks per injection.
    """
    from repro_torch.core.crrm import CRRM
    from repro_torch.sim.faults import FaultConfig
    from repro_torch.sim.mobility import ChurnConfig
    from repro_torch.sim.scenarios import make_scenario
    from repro_torch.twin.server import TwinServer

    say = print if verbose else (lambda *a: None)
    sim = CRRM(make_scenario(
        "outage_storm", n_ues=n_ues, n_cells=n_cells,
        faults=FaultConfig(outage_rate_hz=8.0, mean_outage_s=0.02,
                           sleep_rate_hz=8.0, mean_sleep_s=0.02)),
        device=device)
    churn = ChurnConfig(arrival_rate_hz=300.0, mean_lifetime_s=0.2,
                        max_arrivals_per_tti=4)
    srv = TwinServer(
        sim, churn, chunk_tti=chunk, ckpt_dir=ckpt_dir, keep_last=4,
        radio_mode=radio_mode, inc_backend=inc_backend,
        watchdog=WatchdogConfig(max_retries=3, backoff_s=0.01,
                                ckpt_every_chunks=1))
    route = srv.inc_backend
    rows = ("dense radio, no incremental rows"
            if srv.fns.inc_backend is None
            else f"incremental rows {srv.fns.inc_backend!r}"
            + (f" ({srv.fns.inc_reason})" if srv.fns.inc_reason else ""))
    say(f"[chaos] {n_ues} UEs x {sim.n_cells} cells on {sim.device}: "
        f"inc_backend={route!r} resolves to {rows}")

    k, healthy_s = _timed(srv.step_chunk)          # healthy storm chunk
    down = [k["mean_cells_down"]]
    say(f"[chaos] storm serving: t={srv.t} "
        f"mean_cells_down={k['mean_cells_down']:.2f} "
        f"reattach_events={k['reattach_events']:.0f}; healthy chunk "
        f"{healthy_s:.3f} s")
    recovery = {}

    def report(name, seconds):
        recovery[name] = (seconds, seconds / healthy_s)
        say(f"[chaos] survived {name}: t={srv.t}, recovery {seconds:.3f} s "
            f"= {seconds / healthy_s:.2f} healthy chunks, "
            f"{len(srv.fault_history)} history lines")

    # -- injection 1: poisoned carry ------------------------------------
    t_before = srv.t
    _poison(srv)
    k, s = _timed(srv.step_chunk)                  # guard -> rollback -> retry
    _require(srv.t == t_before + chunk, "NaN recovery lost TTIs")
    _require(any("GuardViolation" in line for line in srv.fault_history),
             "guard never tripped on the injected NaN")
    _require(_finite(k), "post-recovery KPIs not finite")
    down.append(k["mean_cells_down"])
    report("injected NaN", s)

    # -- injection 2: crashing chunk ------------------------------------
    real_chunk, boom = srv._chunk, {"armed": True}

    def _exploding(static, state, power, fairness):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected kernel failure")
        return real_chunk(static, state, power, fairness)

    srv._chunk = _exploding
    t_before = srv.t
    k, s = _timed(srv.step_chunk)
    _require(srv.t == t_before + chunk, "crash recovery lost TTIs")
    _require(any("injected kernel failure" in line
                 for line in srv.fault_history), "crash not recorded")
    _require(srv.inc_backend == route and not any(
        "degrad" in line for line in srv.fault_history),
        "recovery changed the route")
    down.append(k["mean_cells_down"])
    report("injected chunk crash", s)
    srv._chunk = real_chunk

    # -- injection 3: corrupted latest checkpoint -----------------------
    bad_step = _corrupt_latest(ckpt_dir)
    _poison(srv)                                   # force a rollback
    k, s = _timed(srv.step_chunk)
    rollbacks = [line for line in srv.fault_history if "rolled back" in line]
    _require(rollbacks, "no rollback recorded")
    last_rb = rollbacks[-1]
    _require(f"t={bad_step}" not in last_rb,
             "rollback resurrected the corrupted checkpoint")
    _require(_finite(k), "post-recovery KPIs not finite")
    down.append(k["mean_cells_down"])
    report(f"corrupt latest checkpoint (step {bad_step} skipped, "
           f"{last_rb})", s)

    # the drill must end able to serve cleanly, on the route it began on
    k = srv.step_chunk()
    _require(_finite(k) and k["served_mbits"] > 0.0,
             "the final chunk served nothing or non-finite KPIs")
    _require(srv.inc_backend == route, "the route changed")
    down.append(k["mean_cells_down"])
    # over the drill's five chunks: a 20-TTI chunk of 7 cells sees no
    # outage with probability ~1/3 at these rates
    _require(max(down) > 0.0, "fault storm produced no outages")
    for line in srv.fault_history:
        say(f"[chaos] history: {line}")
    return dict(k, recovery=recovery)


def main(argv=None) -> None:
    import argparse

    from repro_torch.obs.telemetry import format_summary

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny twin, the full injection sequence")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ues", type=int, default=64)
    ap.add_argument("--cells", type=int, default=7)
    ap.add_argument("--chunk", type=int, default=20)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as td:
        kpis = drill(td, n_ues=args.ues, n_cells=args.cells,
                     chunk=args.chunk, device=args.device)
    kpis.pop("recovery")
    print(format_summary(kpis))
    print("CHAOS_OK: twin survived NaN injection, chunk crash and "
          "checkpoint corruption")


if __name__ == "__main__":
    main()
