"""The training loop: resume, preemption-safe checkpoints, async saves.

The port of ``repro.train.loop`` on one device.  Fault-tolerance contract:
  * checkpoints are atomic + keep-k (``train.checkpoint``), written every
    ``ckpt_every`` steps, at the last step and on SIGTERM (preemption
    hook), with ``extra={"train_step": n}``;
  * the data stream is a pure function of (seed, step), so a restart
    resumes the exact batch sequence;
  * step metrics stream to stdout as CSV for the harness to scrape.

With a ``mesh`` (``core.distributed.Mesh``, e.g.
``parallel.mesh.make_host_mesh``) every rank of the mesh calls ``train``
with the same arguments: the step is ``train.step.jit_train_step``'s ZeRO-3
step, each rank holding its blocks of the state; a checkpoint holds the
global leaves (gathered by every rank, written by rank 0), and a restore
takes each rank's block of them under the *current* mesh
(``checkpoint.restore(shardings=)``), so a run resumes on another mesh
shape -- elastic across restarts.  Every rank prints the CSV lines.
"""
from __future__ import annotations

import signal
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.parallel import act_sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import Prefetcher
from repro_torch.train.step import (init_state, jit_train_step,
                                    make_train_step, state_specs,
                                    unblock_tree)
from repro_torch.tree import flatten, unflatten


def train(arch, optimizer, mesh, data_source, *, steps: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
          keep_last: int = 3, accum_steps: int = 1, log_every: int = 10,
          seed: int = 0, resume: bool = True, device=None):
    """Train ``arch`` to ``steps`` on ``device`` (None: the card; with a
    ``mesh``, on ``mesh.device``), from the latest checkpoint under
    ``ckpt_dir`` when ``resume``.  Returns ``(state, history)``, the
    losses of the logged steps (with a mesh, the state is this rank's
    blocks)."""
    if mesh is None:
        dev = resolve_device(device)
        step_fn = make_train_step(arch, optimizer, accum_steps=accum_steps)
        state = init_state(arch, optimizer, seed=seed, device=dev)
        full_state = lambda st: st
        target, state_sh = state, None
    else:
        dev = mesh.device
        batch_shapes = {k: torch.empty(np.shape(v), device="meta",
                                       dtype=torch.as_tensor(v).dtype)
                        for k, v in data_source.batch_at(0).items()}
        step_fn, shapes, state_sh, _ = jit_train_step(
            arch, optimizer, mesh, batch_shapes, accum_steps=accum_steps)
        specs = state_specs(arch, optimizer, mesh)[1]
        full_state = lambda st: unblock_tree(mesh, st, specs)
        # restore reads only the target's structure, dtypes and devices
        _, leaves = flatten(shapes)
        target = unflatten(shapes, [torch.empty(0, dtype=x.dtype, device=dev)
                                    for x in leaves])
        state = None
    writer = mesh is None or mesh.rank == 0
    start_step = 0
    if ckpt_dir and resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            # restore builds fresh tensors on the target's devices (each
            # rank's block under state_sh)
            state, extra = ckpt.restore(ckpt_dir, last, target, state_sh)
            start_step = int(extra.get("train_step", last))
            print(f"# resumed from {ckpt_dir} step {start_step}",
                  flush=True)
    if state is None:
        state = init_state(arch, optimizer, mesh, seed, dev)

    stop = {"now": False}

    def _preempt(signum, frame):
        stop["now"] = True

    old_term = signal.signal(signal.SIGTERM, _preempt)
    prefetch = Prefetcher(data_source, start_step=start_step)
    print("step,loss,accuracy,grad_norm,lr,tokens_per_s", flush=True)
    t_last, tok_count = time.perf_counter(), 0
    history = []
    pending_save = None
    try:
        for i in range(start_step, steps):
            _, batch = prefetch.next()
            dev_batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
            state, metrics = step_fn(state, dev_batch)
            tok_count += int(np.prod(batch["tokens"].shape))
            if (i + 1) % log_every == 0 or i + 1 == steps:
                m = {k: float(v) for k, v in metrics.items()}
                tps = tok_count / max(time.perf_counter() - t_last, 1e-9)
                print(f"{i+1},{m['loss']:.4f},{m['accuracy']:.4f},"
                      f"{m['grad_norm']:.3f},{m['lr']:.2e},{tps:.0f}",
                      flush=True)
                history.append(m["loss"])
                t_last, tok_count = time.perf_counter(), 0
            if ckpt_dir and ((i + 1) % ckpt_every == 0 or stop["now"]
                             or i + 1 == steps):
                full = full_state(state)
                if writer:
                    if pending_save is not None:
                        pending_save.join()
                    pending_save = ckpt.save_async(
                        ckpt_dir, i + 1, full, keep_last,
                        extra={"train_step": i + 1})
            if stop["now"]:
                print(f"# preempted at step {i+1}; checkpoint queued",
                      flush=True)
                break
    finally:
        prefetch.close()
        if pending_save is not None:
            pending_save.join(timeout=300)   # durability before return
        signal.signal(signal.SIGTERM, old_term)
        if mesh is not None:
            act_sharding.clear()
    return state, history
