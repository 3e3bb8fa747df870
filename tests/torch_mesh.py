"""Mesh ranks for the ``test_torch_*`` mesh tests: gloo process groups on
the CPU, one subprocess per rank.

The pytest process runs the reference (JAX) single-device and in-process,
records the draws the port consumes (:class:`Recorder`) and writes the
job's inputs to a file; :func:`run_ranks` then starts ``world`` ranks with
``multiprocessing``'s ``spawn`` start method.  A rank imports only
``torch``, numpy and ``repro_torch`` (this module imports nothing else;
``tests/test_torch_hygiene.py`` scans it), joins a gloo group through a
``FileStore`` in the test's own directory (no port is shared between
xdist workers), runs the job named in the inputs on
:class:`RecordedDraws` and writes its outputs.

Nothing can hang: every group has a ``timeout``, each rank runs one
thread, and the parent polls the ranks against a deadline, killing them
all as soon as one fails or the deadline passes.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import flatten

#: seconds a collective waits for a peer before it raises
COLLECTIVE_TIMEOUT = 60
#: seconds a whole spawn may take before its ranks are killed
DEADLINE = 240


class Recorder:
    """Wraps a draws object and records every draw the engine takes, keyed
    by (method, TTI); :class:`RecordedDraws` replays them."""

    def __init__(self, inner):
        self.inner, self.record = inner, {}

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(t, *args):
            out = fn(t, *args)
            self.record[f"{name}/{int(t)}"] = out
            return out
        return call


class RecordedDraws:
    """The draws of a :class:`Recorder`, replayed by method and TTI (on the
    CPU; a rank draws at global shape and slices, as on one device)."""

    def __init__(self, record):
        self.record = record

    def _get(self, name, t):
        return self.record[f"{name}/{int(t)}"]

    def walk(self, t, n, step_m):
        return self._get("walk", t)

    def window(self, t, n, n_move, step_m):
        return self._get("window", t)

    def fading(self, t, cfg, n_ues, n_cells):
        return self._get("fading", t)

    def traffic(self, t, traffic_step):
        return self._get("traffic", t)

    def harq_uniform(self, t, n):
        return self._get("harq_uniform", t)

    def harq_bernoulli(self, t, p, n):
        return self._get("harq_bernoulli", t)

    def fault_uniform(self, t, n_cells):
        return self._get("fault_uniform", t)


@contextmanager
def one_rank_group(tmp_path, backend="gloo"):
    """A 1-rank default group in this process (the trivial mesh),
    destroyed on exit."""
    store = dist.FileStore(os.path.join(str(tmp_path), "store1"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(
                                seconds=COLLECTIVE_TIMEOUT))
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_ranks(job: dict, world: int, tmp_path, deadline=DEADLINE) -> list:
    """Run ``JOBS[job["name"]](job, mesh_world)`` on ``world`` gloo ranks;
    returns each rank's output dict.  Raises with the failing rank's
    traceback, or when the deadline passes."""
    d = str(tmp_path)
    torch.save(job, os.path.join(d, "job.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, d))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > end:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{deadline} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    errors = [open(os.path.join(d, f"rank{r}.err")).read()
              for r in range(world)
              if os.path.exists(os.path.join(d, f"rank{r}.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"mesh ranks failed (exit codes "
                           f"{[p.exitcode for p in procs]}):\n"
                           + "\n".join(errors))
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, d: str):
    torch.set_num_threads(1)
    try:
        job = torch.load(os.path.join(d, "job.pt"), weights_only=False)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            out = JOBS[job["name"]](job)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(d, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)


# ---------------------------------------------------------------- the jobs
def port_sim(case):
    """The port simulator of a case: the reference's params fields and
    roots (``torch_parity.port_of`` without the reference)."""
    from repro_torch import convert
    return convert.crrm_from_reference(case["fields"], case["roots"], "cpu")


def _np(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        vals = [_np(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x.detach().cpu().numpy()


def rollout_case(case, mesh, fns_kw=None):
    """One case's mesh rollout on its recorded draws: the global
    ``(state, tput[, telem])`` as numpy."""
    from repro_torch import convert
    sim = port_sim(case)
    fns = sim.episode_fns(mesh=mesh, **(fns_kw or case["fns_kw"]))
    static = convert.episode_static(case["static"], "cpu")
    state = convert.episode_state(case["state"], "cpu")
    action = case.get("action")
    out = fns.rollout(static, state, case["n_tti"],
                      RecordedDraws(case["record"]),
                      None if action is None else torch.as_tensor(action))
    return tuple(_np(x) for x in out) + (fns.inc_backend,)


def job_rollouts(job):
    """Every case of ``job["cases"]`` on the mesh its ``mesh`` entry names
    (shape, axis names, ``episode_fns`` mesh keywords)."""
    from repro_torch.core.distributed import make_mesh
    meshes, out = {}, {}
    for name, case in job["cases"].items():
        shape, axes, kw = case["mesh"]
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_mesh(shape, axes, "cpu")
        out[name] = rollout_case(case, meshes[key],
                                 dict(case["fns_kw"], **kw))
    # layouts that must be refused: the error of each
    out["refusals"] = {}
    for name, (case, (shape, axes, kw)) in job.get("refusals", {}).items():
        mesh = meshes.get((tuple(shape), tuple(axes)))
        if mesh is None:
            mesh = meshes[(tuple(shape), tuple(axes))] = make_mesh(
                shape, axes, "cpu")
        try:
            port_sim(case).episode_fns(mesh=mesh, **kw)
        except ValueError as e:
            out["refusals"][name] = str(e)
    return out


def job_steps(job):
    """The three step makers of ``core.distributed`` on a (4, 2) mesh, and
    ``_global_best`` on tied inputs."""
    from repro_torch.core import distributed as D
    from repro_torch.sim.pathloss import make_pathloss
    mesh = D.make_mesh((4, 2), ("data", "model"), "cpu")
    t = {k: torch.as_tensor(v) for k, v in job["inputs"].items()}
    pl = make_pathloss("UMa").get_pathgain
    args = (mesh, pl, job["noise"], job["n_cells"], job["bw"], 0.0)
    out = {}
    for name in ("materialized", "streaming"):
        f = getattr(D, f"make_{name}_step")(*args)
        out[name] = _np(tuple(f(t["U"], t["C"], t["Pw"])))
    f = D.make_incremental_rows_step(*args)
    out["incremental"] = _np(tuple(f(
        t["U"], t["C"], t["Pw"], t["w"], t["u"], t["a"], t["bv"],
        t["idx"], t["new_pos"])))
    # the cross-shard argmax over each set of axes of the mesh
    for axes in (("model",), ("data",), ("data", "model")):
        ax = mesh.axes(axes)
        vals = t["ties"]
        n_loc = vals.shape[1] // ax.size
        loc = vals[:, ax.index * n_loc:(ax.index + 1) * n_loc]
        gmax, a, _ = D._global_best(loc.amax(dim=1),
                                    torch.argmax(loc, dim=1).to(torch.int32),
                                    n_loc, ax)
        out["best/" + "+".join(axes)] = (_np(gmax), _np(a))
    return out


def job_env(job):
    """``CrrmEnv(mesh=)`` steps and one unbatched PPO collection step on a
    UE mesh of all the ranks, on the port's own draws."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.env.crrm_env import CrrmEnv, EnvObs
    from repro_torch.rl.rollout import (RolloutDraws, initial_features,
                                        make_collect_fn)
    mesh = make_mesh((dist.get_world_size(),), ("ue",), "cpu")
    env = CrrmEnv(mesh=mesh, device="cpu", **job["env_kw"])
    out = {"steps": []}
    state, _ = env.reset(job["seed"])
    for _ in range(job["n_steps"]):
        state, obs, reward, done, info = env.step(state)
        out["steps"].append((_np(state), _np(obs), _np(reward), _np(done),
                             _np(info["telemetry"])))
    for batch in (lambda: env.reset_batch([0, 1]),
                  lambda: env.step_batch(state)):
        try:
            batch()
        except ValueError as e:
            out.setdefault("batch_errors", []).append(str(e))
    cfg, params = job["policy"]
    collect = make_collect_fn(env, cfg, 1)
    state, obs = env.reset(job["seed"])
    feats = initial_features(env, cfg, EnvObs(obs.tput[None],
                                              obs.backlog[None]))
    draws = RolloutDraws(job["seed"], "cpu")
    state, feats, traj, last = collect(params, state, feats, draws, 0)
    out["ppo"] = (_np(state), _np(feats), _np(tuple(traj)), _np(last))
    try:
        collect(params, state, feats.expand(2, -1), draws, 1)
    except ValueError as e:
        out["ppo_error"] = str(e)
    return out


def job_restore(job):
    """``checkpoint.restore(shardings=)`` of a checkpoint written unsharded,
    onto a (2, 2) mesh."""
    from repro_torch.core.distributed import NamedSharding, P, make_mesh
    from repro_torch.train import checkpoint as ckpt
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    target = {"w": torch.zeros((8, 4)), "b": torch.zeros((4,))}
    sh = {"w": NamedSharding(mesh, P("data", "model")),
          "b": NamedSharding(mesh, P("model"))}
    tree, extra = ckpt.restore(job["dir"], 5, target, sh)
    latest, _, step = ckpt.restore_latest_valid(job["dir"], target, sh)
    return {"tree": {k: _np(v) for k, v in tree.items()}, "extra": extra,
            "latest": {k: _np(v) for k, v in latest.items()}, "step": step,
            "coord": dict(mesh.coord)}


def job_card(job):
    """On the card: a UE mesh of all the ranks (gloo with CUDA tensors)
    against one device on the port's own draws, and the fused_sinr
    launches of the mesh run."""
    from repro_torch.core.crrm import CRRM
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.params import CRRM_parameters
    from repro_torch.kernels import fused_sinr as fk
    from repro_torch.mac.engine import Draws
    mesh = make_mesh((dist.get_world_size(),), ("ue",), "cuda")
    sim = CRRM(CRRM_parameters(**job["params"]), device="cuda")
    static, state = sim.episode_static(), sim.init_episode_state()
    outs = []
    for m in (None, mesh):
        fns = sim.episode_fns(mesh=m, **job["fns_kw"])
        before = fk.fused_sinr_accumulate.launches
        out = fns.rollout(static, state, job["n_tti"], Draws(3, "cuda"))
        outs.append((_np(out[0]), _np(out[1]),
                     fk.fused_sinr_accumulate.launches - before))
    return outs


def job_collectives(job):
    """A psum of a (100, 3) float32 and a pmax of a (7,) int32 over a UE
    mesh of all the ranks, inside ``count_collectives``; the process-wide
    count's growth over the same region."""
    from repro_torch.core import distributed as D
    mesh = D.make_mesh((dist.get_world_size(),), ("data",), "cpu")
    ax = mesh.axes("data")
    before = D.collective_stats()
    with D.count_collectives() as c:
        s = D.psum(torch.ones(100, 3), ax)
        D.pmax(torch.arange(7, dtype=torch.int32), ax)
    after = D.collective_stats()
    return {"counts": c.counts, "bytes_by_kind": c.bytes_by_kind,
            "total_wire_bytes": c.total_wire_bytes, "sum": _np(s),
            "process": after.total_wire_bytes - before.total_wire_bytes}


def lm_setup(run):
    """The port's arch, optimizer and data of an LM run: reduced
    ``run["arch"]`` (widened by ``run["cfg"]``), ``run["opt"]`` =
    (name, kwargs) over ``warmup_cosine(*run["lr"])``, ``SyntheticLM``
    (``run["batch"]``) from seed 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.registry import make_arch
    from repro_torch.train import optim
    from repro_torch.train.data import SyntheticLM
    cfg = dataclasses.replace(get_config(run["arch"], reduced=True),
                              **run.get("cfg", {}))
    name, kw = run["opt"]
    opt = optim.OPTIMIZERS[name](optim.warmup_cosine(*run["lr"]), **kw)
    b, s = run["batch"]
    return make_arch(cfg), opt, SyntheticLM(cfg.vocab_size, b, s, seed=0)


def job_lm_train(job):
    """``train.loop.train(mesh=)`` runs in turn on meshes of all the ranks
    (each ``run``: mesh shape, strategy, checkpoint directory, steps, the
    :func:`lm_setup` keys): each run's logged losses and the collectives
    of its steps."""
    from repro_torch.core import distributed as D
    from repro_torch.parallel import mesh as M
    from repro_torch.train.loop import train
    from repro_torch.train.step import state_specs, unblock_tree
    out = []
    for run in job["runs"]:
        M.set_strategy(run.get("strategy", "2d"))
        try:
            mesh = D.make_mesh(run["mesh"], ("data", "model"), "cpu")
            arch, opt, data = lm_setup(run)
            with D.count_collectives() as c:
                state, hist = train(arch, opt, mesh, data,
                                    steps=run["steps"], ckpt_dir=run["dir"],
                                    ckpt_every=run.get("ckpt_every", 100),
                                    log_every=1,
                                    accum_steps=run.get("accum", 1))
            res = {"hist": hist, "counts": dict(c.counts),
                   "wire": c.total_wire_bytes}
            if run.get("params"):
                specs = state_specs(arch, opt, mesh)[1]
                res["params"] = [_np(x) for x in flatten(unblock_tree(
                    mesh, state["params"], specs["params"]))[1]]
        finally:
            M.set_strategy("2d")
        out.append(res)
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def job_optim(job):
    """Each optimizer's sharded update (this rank's blocks, ``shards=``)
    against its unsharded update of the whole tree, over ``job["grads"]``
    (one tree per step) on each mesh of ``job["meshes"]`` ((shape,
    strategy)): the full params, states and metrics of both, gathered."""
    from repro_torch.core import distributed as D
    from repro_torch.parallel import mesh as M
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import zero
    from repro_torch.train import optim
    from repro_torch.train.step import block_tree, unblock_tree
    params = _torch_tree(job["params"])
    grads = [_torch_tree(g) for g in job["grads"]]
    out = {}
    for shape, mode in job["meshes"]:
        M.set_strategy(mode)
        try:
            mesh = D.make_mesh(shape, ("data", "model"), "cpu")
            specs = shd.infer_param_specs(params, mesh)
            shards = zero.Shards.of(mesh, params, specs)
            for name in ("adamw", "adafactor", "sgdm"):
                opt = optim.OPTIMIZERS[name](optim.warmup_cosine(1e-2, 1,
                                                                 10))
                state = opt.init(params)
                s_specs = shd.infer_param_specs(state, mesh)
                p_full, s_full = params, state
                p_blk = block_tree(mesh, params, specs)
                s_blk = block_tree(mesh, state, s_specs)
                ms = []
                for g in grads:
                    p_full, s_full, m_full = opt.update(g, s_full, p_full)
                    p_blk, s_blk, m_blk = opt.update(
                        block_tree(mesh, g, specs), s_blk, p_blk,
                        shards=shards)
                    ms.append(({k: float(v) for k, v in m_full.items()},
                               {k: float(v) for k, v in m_blk.items()}))
                full = [_np(x) for x in flatten((p_full, s_full))[1]]
                sharded = [_np(x) for x in flatten((
                    unblock_tree(mesh, p_blk, specs),
                    unblock_tree(mesh, s_blk, s_specs)))[1]]
                out[(tuple(shape), mode, name)] = {
                    "full": full, "sharded": sharded, "metrics": ms,
                    "specs": [tuple(sp) for sp in shd.spec_leaves(specs)]}
        finally:
            M.set_strategy("2d")
    return out


JOBS = {"rollouts": job_rollouts, "steps": job_steps, "env": job_env,
        "restore": job_restore, "card": job_card,
        "collectives": job_collectives, "lm_train": job_lm_train,
        "optim": job_optim}


def same_on_every_rank(outs):
    """Every rank returned bit-identical outputs (replicated values)."""
    def walk(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert a.tobytes() == b.tobytes(), path
        else:
            assert a == b, path
    for r, o in enumerate(outs[1:], 1):
        walk(outs[0], o, f"rank{r}")
