"""A cell over several ranks: rank 0 is the process the benchmark started,
ranks 1..N-1 are spawned here, and every rank runs the cell in lockstep.

:func:`crrm_bench.harness.main.run` takes this path for a workload with
``"chips"`` above 1, or one whose entry kind spans ranks
(``Entry.spans_ranks``); every other cell runs in one process and never
imports this module.

* Each rank pins ``cuda:<rank>`` (the CPU in the harness's tests) and joins
  the default group, NCCL on the card and gloo on the CPU, through a
  ``FileStore`` in a temporary directory, so no port is needed.  A second
  group, gloo, carries the host handshakes, so none of them enters the
  NCCL stream.  Every collective has a timeout.
* Every rank sets up and warms up, and meets the others after each.  Before
  each window call rank 0 broadcasts go or stop, so rank 0's clock alone
  decides; a call ends once every rank has synchronised its device and met
  at a barrier, so the window's times cover the slowest rank.
* After the window each worker sends rank 0 its :func:`report`, and every
  rank then leaves the groups at once (NCCL's tear-down waits for all of
  them); rank 0 reads the ranks as one result and checks ``correct``
  alone.
* A worker that raises, or that is still running :data:`SETUP_ALLOWANCE_S`
  seconds past ``--seconds`` from the run's start, ends the run: rank 0
  prints why on standard error, kills every worker and exits non-zero with
  no result.  A worker dies with rank 0.
"""
from __future__ import annotations

import ctypes
import datetime
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a rank may take beyond ``--seconds``, counted from the run's
#: start: spawn, imports, set-up, warm-up, the window's last call and the
#: report.  A run must end within 360 s.
SETUP_ALLOWANCE_S = 240.0
#: how often rank 0 looks at its workers, in seconds
POLL_S = 0.05
#: seconds rank 0 waits for a worker to end once the reports are in
QUIT_S = 30.0
#: exit code of a run that a worker rank ended
EXIT_RANK_FAILED = 1
_PR_SET_PDEATHSIG = 1


class RankContext(NamedTuple):
    """What an entry kind learns of its rank (``Base(..., ranks=)``)."""

    rank: int
    world: int
    backend: str      # the default group's: "nccl" on the card, "gloo"
    host: object      # the gloo group of the host handshakes


def _device(device: str, rank: int) -> torch.device:
    if device == "cuda":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device(device)


def _join(rank: int, world: int, store_dir: str, dev: torch.device,
          timeout_s: float) -> RankContext:
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    host = dist.new_group(backend="gloo", timeout=timeout)
    return RankContext(rank, world, backend, host)


def _sync(dev: torch.device, ctx: RankContext):
    """This rank's device synchronised, then every rank met."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group=ctx.host)


def _flag(ctx: RankContext, go: bool = False) -> bool:
    """Rank 0's go (True) or stop (False), on every rank."""
    t = torch.tensor([int(go)], dtype=torch.int32)
    dist.broadcast(t, src=0, group=ctx.host)
    return bool(t.item())


def report(entry, dev: torch.device, calls: int, tr) -> dict:
    """What a rank tells rank 0 once the window has closed: its peak
    memory, launches, failed calls, forbidden modules and, traced, its busy
    and window seconds."""
    from crrm_bench.harness import main, trace
    out = {"rank": entry.ranks.rank, "calls": calls,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
           if dev.type == "cuda" else 0,
           "launches": main.launch_counts(), "failed": entry.failed(),
           "forbidden": main.forbidden_modules()}
    if tr is not None:
        out.update(busy_s=trace.busy_s(tr), window_s=tr.window_s)
    return out


class Team:
    """Rank 0's side of a run over ``cell.chips`` ranks.  The workers are
    spawned at construction, so that their imports overlap rank 0's;
    :meth:`join` joins the groups; leaving the ``with`` block waits for
    the workers to end, or kills them where the block raised."""

    def __init__(self, cell, seed: int, seconds: float, trace_on: bool,
                 device: str, t_start: float, worker_hook=None):
        self.world = int(cell.chips)
        self.timeout_s = float(seconds) + SETUP_ALLOWANCE_S
        self.deadline = t_start + self.timeout_s
        self.dir = tempfile.TemporaryDirectory(prefix="crrm_bench_ranks_")
        self.device = _device(device, 0)
        self.ctx = None
        spawn = mp.get_context("spawn")
        self.procs = [spawn.Process(
            target=_worker, daemon=True,
            args=(r, self.world, self.dir.name, cell, seed, trace_on, device,
                  self.timeout_s, os.getpid(), worker_hook))
            for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watch_workers,
                                       daemon=True)
        self._watch.start()

    def join(self) -> RankContext:
        self.ctx = _join(0, self.world, self.dir.name, self.device,
                         self.timeout_s)
        return self.ctx

    def go(self):
        _flag(self.ctx, True)

    def stop(self):
        _flag(self.ctx, False)

    def sync(self):
        _sync(self.device, self.ctx)

    def gather(self, mine: dict) -> list:
        """Every rank's :func:`report`, in rank order; every rank leaves
        the groups after it."""
        out = [None] * self.world
        dist.gather_object(mine, out, dst=0, group=self.ctx.host)
        dist.destroy_process_group()
        return out

    # -- the watch over the workers --------------------------------------
    def _watch_workers(self):
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                if p.exitcode not in (None, 0):
                    self._abort(f"rank {r} ended with exit code "
                                f"{p.exitcode}", r)
            alive = [r for r, p in enumerate(self.procs, 1) if p.is_alive()]
            if not alive:
                return
            if time.perf_counter() > self.deadline:
                self._abort(f"ranks {alive} still running "
                            f"{self.timeout_s:.0f} s after the run's start "
                            f"(--seconds + SETUP_ALLOWANCE_S)")

    def _abort(self, why: str, rank: int | None = None):
        """End the run from the watch thread: rank 0 may be waiting in a
        collective that never completes."""
        err = os.path.join(self.dir.name, f"rank{rank}.err")
        tb = ""
        if rank and os.path.exists(err):
            with open(err) as fh:
                tb = fh.read()
        print(f"crrm_bench: {why}\n{tb}", file=sys.stderr, flush=True)
        self._kill()
        os._exit(EXIT_RANK_FAILED)

    def _kill(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(10)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self._done.set()
        self._watch.join()
        if exc_type is None:
            for p in self.procs:
                p.join(QUIT_S)
        self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        self.dir.cleanup()
        _stop_resource_tracker()


def _stop_resource_tracker():
    """End the helper process that ``spawn`` starts beside the workers."""
    from multiprocessing import resource_tracker
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def _die_with_parent(parent: int):
    """Have the kernel kill this process when rank 0 ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(_PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(EXIT_RANK_FAILED)


def _worker(rank, world, store_dir, cell, seed, trace_on, device,
            timeout_s, parent, hook):
    """A worker rank: the cell in lockstep with rank 0, then its report.
    Its traceback, if it raises, goes to ``rank<r>.err`` for rank 0."""
    os.dup2(2, 1)        # standard output is rank 0's alone
    _die_with_parent(parent)
    try:
        if hook is not None:
            hook(rank)
        _serve(rank, world, store_dir, cell, seed, trace_on, device,
               timeout_s)
    except BaseException:
        with open(os.path.join(store_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(f"rank {rank}:\n{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(EXIT_RANK_FAILED)
    sys.stderr.flush()
    os._exit(0)      # the groups are gone; skip the interpreter's tear-down


def _serve(rank, world, store_dir, cell, seed, trace_on, device, timeout_s):
    from crrm_bench.harness import main, manifest, trace
    if device == "cpu":
        torch.set_num_threads(1)     # the tests run several CPU ranks at once
    dev = _device(device, rank)
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ctx = _join(rank, world, store_dir, dev, timeout_s)
    kind = manifest.entry_kind(cell.bench_dir, cell.traffic["entry"])
    entry = kind.Entry(cell, seed, dev, ranks=ctx)
    calls = 0

    def window():
        nonlocal calls
        while _flag(ctx):
            entry.call()
            _sync(dev, ctx)
            calls += 1

    try:
        entry.setup()
        _sync(dev, ctx)
        entry.warmup()
        _sync(dev, ctx)
        main.zero_launches()
        tr = trace.profile(window) if trace_on else window()
        mine = report(entry, dev, calls, tr)
    finally:
        entry.close()
        del entry
    dist.gather_object(mine, None, dst=0, group=ctx.host)
    dist.destroy_process_group()
