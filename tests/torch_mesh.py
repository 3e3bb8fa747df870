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
from contextlib import contextmanager, nullcontext

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


def continue_run(run, mesh, state, steps):
    """The loop's steps from ``state`` (a global train state held in
    memory, no checkpoint) to ``steps`` on ``mesh``: the run uninterrupted
    across a change of mesh.  Returns ``(logged losses, global state)``."""
    from repro_torch.parallel import act_sharding
    from repro_torch.train.step import (block_tree, jit_train_step,
                                        state_specs, unblock_tree)
    arch, opt, data = lm_setup(run)
    shapes = {k: torch.empty(np.shape(v), device="meta",
                             dtype=torch.as_tensor(v).dtype)
              for k, v in data.batch_at(0).items()}
    fn = jit_train_step(arch, opt, mesh, shapes)[0]
    specs = state_specs(arch, opt, mesh)[1]
    state = block_tree(mesh, state, specs)
    hist = []
    try:
        for i in range(int(state["step"]), steps):
            batch = {k: torch.as_tensor(v)
                     for k, v in data.batch_at(i).items()}
            state, metrics = fn(state, batch)
            hist.append(float(metrics["loss"]))
        return hist, unblock_tree(mesh, state, specs)
    finally:
        act_sharding.clear()


def job_lm_train(job):
    """``train.loop.train(mesh=)`` runs in turn on meshes of all the ranks
    (each ``run``: mesh shape, strategy, checkpoint directory, steps, the
    :func:`lm_setup` keys): each run's logged losses, the collectives of
    its steps and the shapes of its param blocks.  A run with ``switch``
    (mesh, strategy, steps) then goes on in memory on that mesh
    (:func:`continue_run`); with ``state`` it also returns its final
    global train state."""
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
            keys, leaves = flatten(state["params"])
            res = {"hist": hist, "counts": dict(c.counts),
                   "wire": c.total_wire_bytes,
                   "blocks": {k: tuple(x.shape)
                              for k, x in zip(keys, leaves)}}
            if not any(run.get(k) for k in ("switch", "params", "state")):
                out.append(res)
                continue
            specs = state_specs(arch, opt, mesh)[1]
            state = unblock_tree(mesh, state, specs)
            if run.get("switch"):
                shape, strategy, steps = run["switch"]
                M.set_strategy(strategy)
                more, state = continue_run(
                    run, D.make_mesh(shape, ("data", "model"), "cpu"),
                    state, steps)
                res["hist"] = hist + more
            if run.get("params"):
                res["params"] = [_np(x)
                                 for x in flatten(state["params"])[1]]
            if run.get("state"):
                res["state"] = _tree_np(state)
        finally:
            M.set_strategy("2d")
        out.append(res)
    return out


def job_lm_step(job):
    """Sharded train steps of each run (the :func:`lm_setup` keys, mesh,
    steps) from the seeded initial state, or from the global train state
    saved at ``init`` (``torch.save``): per step the loss, the gradient
    norm and the all-reduces made (count, and the (shape, dtype) of
    each); with ``delta`` also the global params' change of step 1, with
    ``grads`` the global gradient of step 1 (before clipping)."""
    import dataclasses
    from repro_torch.core import distributed as D
    from repro_torch.train.step import (block_tree, init_state,
                                        jit_train_step, state_specs,
                                        unblock_tree)
    out = []
    for run in job["runs"]:
        mesh = D.make_mesh(run["mesh"], ("data", "model"), "cpu")
        arch, opt, data = lm_setup(run)
        seen_grads = []
        if run.get("grads"):
            def spy_update(grads, *a, update=opt.update, **k):
                seen_grads.append(grads)
                return update(grads, *a, **k)
            opt = dataclasses.replace(opt, update=spy_update)
        batch0 = data.batch_at(0)
        fn = jit_train_step(arch, opt, mesh, {
            k: torch.empty(np.shape(v), device="meta",
                           dtype=torch.as_tensor(v).dtype)
            for k, v in batch0.items()})[0]
        specs = state_specs(arch, opt, mesh)[1]
        state = (block_tree(mesh, torch.load(run["init"]), specs)
                 if run.get("init") else init_state(arch, opt, mesh, 0,
                                                    "cpu"))
        p0 = unblock_tree(mesh, state, specs)["params"] \
            if run.get("delta") else None
        steps, seen, spy = [], [], D._all_reduce

        def record(x, ax, op):
            seen.append((tuple(x.shape), str(x.dtype)))
            return spy(x, ax, op)

        for i in range(run["steps"]):
            batch = {k: torch.as_tensor(v)
                     for k, v in data.batch_at(i).items()}
            seen.clear()
            D._all_reduce = record
            try:
                state, m = fn(state, batch)
            finally:
                D._all_reduce = spy
            steps.append({"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "all_reduces": list(seen)})
            if i == 0 and p0 is not None:
                p1 = unblock_tree(mesh, state, specs)["params"]
                keys, a = flatten(p0)
                delta = {k: _np(x - y) for k, x, y in
                         zip(keys, a, flatten(p1)[1])}
        res = {"steps": steps}
        if p0 is not None:
            res["delta"] = delta
        if seen_grads:
            g = unblock_tree(mesh, seen_grads[0], specs["params"])
            res["grads"] = {k: _np(x) for k, x in zip(*flatten(g))}
        out.append(res)
    return out


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


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


# ------------------------------------------------------- tensor parallelism
def _vjp(fn, tree, args, seed=7):
    """``(out, grads of tree's leaves, grads of the float args)`` of
    ``sum(fn(tree, *args) * ct)`` for a cotangent ``ct`` drawn from
    ``seed`` (the same on every rank)."""
    keys, leaves = flatten(tree)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in leaves]
        fa = [a.detach().requires_grad_(True)
              if isinstance(a, torch.Tensor) and a.is_floating_point()
              else a for a in args]
        out = fn(_unflat(tree, xs), *fa)
        ct = torch.randn(out.shape, generator=torch.Generator()
                         .manual_seed(seed))
        wrt = [x for x in xs if x.requires_grad] + [
            a for a in fa if isinstance(a, torch.Tensor) and a.requires_grad]
        gs = torch.autograd.grad((out.float() * ct).sum(), wrt,
                                 allow_unused=True, materialize_grads=True)
    n = sum(x.requires_grad for x in xs)
    return out.detach(), list(gs[:n]), list(gs[n:])


def _unflat(tree, leaves):
    from repro_torch.tree import unflatten
    return unflatten(tree, leaves)


def _tp_case(fn, tree, specs, args, mesh):
    """The sharded ``fn`` (inside ``act_sharding.zero3``: the tree's
    leaves this rank's blocks, gathered by ``gather_layer_params``)
    against the unsharded ``fn`` on the whole tree: outputs, the rank's
    block of the whole gradients beside the sharded gradients, and the
    float args' gradients."""
    from repro_torch.parallel import act_sharding as act
    from repro_torch.parallel import zero
    keys, leaves = flatten(tree)
    blocks = _unflat(tree, [zero.block(mesh, x, s, k) for k, x, s in
                            zip(keys, leaves, specs)])
    full, g_full, a_full = _vjp(fn, tree, args)
    with act.zero3(mesh, dict(zip(keys, specs)), (), train=False):
        got, g_got, a_got = _vjp(
            lambda t, *a: fn(act.gather_layer_params(t), *a), blocks, args)
    return {"out": (_np(full), _np(got)),
            "grads": {k: (_np(zero.block(mesh, g, s, k)), _np(h))
                      for k, g, h, s in zip(keys, g_full, g_got, specs)},
            "arg_grads": [(_np(g), _np(h)) for g, h in zip(a_full, a_got)],
            "blocks": {k: tuple(b.shape) for k, b in
                       zip(keys, flatten(blocks)[1])}}


def _layer0(tree, root, mesh):
    """Layer 0 of the stack ``tree[root]`` and its leaves' specs (the
    stacked leaf's spec without its layer dimension)."""
    from repro_torch.parallel import sharding as shd
    keys, leaves = flatten(tree[root])
    specs = [shd.P(*shd._param_rule(f"layers/{k}", tuple(x.shape),
                                    mesh)[1:]) for k, x in zip(keys, leaves)]
    return _unflat(tree[root], [x[0] for x in leaves]), specs


def _tp_collectives(mesh):
    """``parallel.tp``'s four functions on rank-dependent tensors over a
    ``model`` axis of two ranks: values, gradients of a rank-dependent
    cotangent, and the collectives they made."""
    from repro_torch.core.distributed import count_collectives
    from repro_torch.parallel import tp
    ax = mesh.axes("model")
    r = float(ax.index)
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    ct = torch.arange(6.0).reshape(2, 3) * (r + 1)
    out = {}
    with count_collectives() as c:
        for name, fn, ctn in (
                ("psum", lambda t: tp.psum(t, ax), ct),
                ("copy", lambda t: tp.copy(t, ax), ct),
                ("assemble", lambda t: tp.assemble(t, ax, 1),
                 torch.arange(6.0 * ax.size).reshape(2, -1)),
                ("split", lambda t: tp.split(t, ax, 0), ct[:1])):
            t = x.clone().requires_grad_(True)
            y = fn(t)
            (g,) = torch.autograd.grad((y * ctn).sum(), t)
            out[name] = (_np(y.detach()), _np(g))
    out["counts"] = dict(c.counts)
    out["index"] = ax.index
    return out


def job_tp_modules(job):
    """The modules of ``job["cases"]`` on the mesh ``job["mesh"]``
    (:func:`_tp_case`): the embedding, heads, MLP, one attention + MLP or
    MoE block and the MoE layer, each on the reference's weights."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models import layers, moe, transformer
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh(job["mesh"], ("data", "model"), "cpu")
    out = {"collectives": _tp_collectives(mesh)}
    for name, c in job["cases"].items():
        cfg, params = c["cfg"], _torch_tree(c["params"])
        kind = c["kind"]
        if kind in ("embed", "unembed", "lm_head"):
            root, leaf = (("lm_head", "kernel") if kind == "lm_head"
                          else ("embed", "embedding"))
            w = params[root][leaf]
            spec = shd._param_rule(f"{root}/{leaf}", tuple(w.shape), mesh)
            fn = {"embed": lambda t, tok: layers.embed(t, tok,
                                                       torch.float32),
                  "unembed": layers.unembed,
                  "lm_head": layers.lm_head}[kind]
            arg = torch.as_tensor(c["x"])
            out[name] = _tp_case(fn, {leaf: w}, [spec], (arg,), mesh)
            continue
        lp, specs = _layer0(params, "layers", mesh)
        x = torch.as_tensor(c["x"])
        pos = torch.arange(x.shape[1])[None].expand(x.shape[:2])
        if kind == "mamba":
            sub = [s for k, s in zip(flatten(lp)[0], specs)
                   if k.startswith("ssm/")]
            state = [torch.as_tensor(c[k]) for k in ("h0", "conv0")
                     if k in c]
            out[name] = _tp_case(_mamba_fn(cfg), {"ssm": lp["ssm"]}, sub,
                                 (x, *state), mesh)
            continue
        if kind == "mlp":
            sub = [s for k, s in zip(flatten(lp)[0], specs)
                   if k.startswith("mlp/")]
            out[name] = _tp_case(lambda t, h: layers.mlp(t, h, torch.float32),
                                 lp["mlp"], sub, (x,), mesh)
        elif kind == "moe":
            sub = [s for k, s in zip(flatten(lp)[0], specs)
                   if k.startswith("moe/")]
            out[name] = _tp_case(
                lambda t, h: moe.moe_layer(t, h, cfg, torch.float32),
                lp["moe"], sub, (x,), mesh)
        elif kind == "block":
            out[name] = _tp_case(
                lambda t, h: transformer._attn_mlp_block(
                    t, h, cfg, torch.float32, pos,
                    use_moe=cfg.family == "moe"), lp, specs, (x,), mesh)
    return out


def _mamba_fn(cfg):
    """A Mamba layer of ``cfg`` as one tensor: its output, and with an
    initial state (h0, conv0) also the new ``h`` and ``conv`` (the rank's
    channel blocks under tensor parallelism, cut from the whole initial
    state and assembled, exactly, so that both sides compare whole)."""
    from repro_torch.models import mamba
    from repro_torch.parallel import tp
    fwd = (mamba.mamba1_forward if cfg.ssm_variant == "mamba1"
           else mamba.mamba2_forward)

    def fn(t, x, h0=None, conv0=None):
        p = t["ssm"]
        if h0 is None:
            return fwd(p, x, cfg, torch.float32)
        ax = mamba.channel_axis(p)
        out, h, conv = fwd(p, x, cfg, torch.float32,
                           h0=tp.split(h0, ax, 1),
                           conv0=tp.split(conv0, ax, 2), return_state=True)
        return torch.cat([out.flatten(), tp.assemble(h, ax, 1).flatten(),
                          tp.assemble(conv, ax, 2).flatten()])
    return fn


def job_vocab_ce(job):
    """The vocab-parallel cross entropy (``train.loss.chunked_ce_sums`` on
    the head's ``tp.VocabBlock``) on the mesh ``job["mesh"]`` against the
    unsharded one on the whole head, for each case (features, labels,
    mask, the head's weight and whether it is the tied table): the sums,
    the gradients of the features and of the weight (the rank's block of
    the whole one), the collectives, and the tokens whose whole row has
    its maximum on more than one rank."""
    from repro_torch.core.distributed import P, count_collectives, make_mesh
    from repro_torch.models import layers
    from repro_torch.parallel import act_sharding as act
    from repro_torch.parallel import zero
    from repro_torch.train.loss import chunked_ce_sums
    mesh = make_mesh(job["mesh"], ("data", "model"), "cpu")
    ax = mesh.axes("model")
    out = {}
    for name, c in job["cases"].items():
        feats = torch.as_tensor(c["feats"])
        labels = torch.as_tensor(c["labels"])
        mask = torch.as_tensor(c["mask"])
        w = torch.as_tensor(c["w"])
        tied = c["tied"]
        root, leaf, spec = (("embed", "embedding", P("model", None))
                            if tied else ("lm_head", "kernel",
                                          P(None, "model")))
        head = layers.unembed if tied else layers.lm_head

        def sums(weight, f, vocab_block, sharded):
            if sharded:
                weight = act.gather_leaf(f"{root}/{leaf}", weight, mesh,
                                         spec, (), None, ax)
            return chunked_ce_sums(lambda x: head({leaf: weight}, x,
                                                  vocab_block),
                                   f, labels, chunk=c["chunk"],
                                   z_loss=c["z_loss"], mask=mask)

        res = {}
        for which in ("whole", "sharded"):
            sharded = which == "sharded"
            wt = zero.block(mesh, w, spec) if sharded else w
            with torch.enable_grad():
                wt = wt.detach().requires_grad_(True)
                f = feats.detach().requires_grad_(True)
                with count_collectives() as cc:
                    ctx = (act.zero3(mesh, {}, (), train=True) if sharded
                           else nullcontext())
                    with ctx:          # the backward recomputes inside
                        nll, hits, cnt = sums(wt, f, True, sharded)
                        gw, gf = torch.autograd.grad(nll, (wt, f))
            res[which] = {"sums": [float(x.detach()) for x in
                                   (nll, hits, cnt)],
                          "g_w": _np(gw), "g_f": _np(gf),
                          "counts": dict(cc.counts)}
        res["whole"]["g_w_block"] = _np(zero.block(
            mesh, torch.as_tensor(res["whole"]["g_w"]), spec))
        logits = (feats @ (w.T if tied else w)).reshape(-1, w.shape[
            0 if tied else 1])
        top = logits.max(-1, keepdim=True).values
        n_loc = logits.shape[-1] // ax.size
        owners = (logits == top).reshape(logits.shape[0], ax.size,
                                         n_loc).any(-1).sum(-1)
        res["straddling_ties"] = int((owners > 1).sum())
        out[name] = res
    return out


def job_mamba_layout(job):
    """The Mamba ``in_proj`` layout on the mesh ``job["mesh"]`` under the
    strategy ``job["strategy"]`` (default ``"2d"``): this rank's block of
    the global params (``train.step.block_tree``), the tree assembled back
    from every rank's blocks (``unblock_tree``) and the specs."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.parallel import mesh as M
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import block_tree, unblock_tree
    M.set_strategy(job.get("strategy", "2d"))
    try:
        mesh = make_mesh(job["mesh"], ("data", "model"), "cpu")
        params = _torch_tree(job["params"])
        specs = shd.infer_param_specs(params, mesh)
        blocks = block_tree(mesh, params, specs)
        return {"blocks": _tree_np(blocks),
                "assembled": _tree_np(unblock_tree(mesh, blocks, specs)),
                "specs": {k: [list(a) if isinstance(a, tuple) else a
                              for a in s] for k, s in
                          zip(flatten(params)[0], shd.spec_leaves(specs))},
                "coord": dict(mesh.coord)}
    finally:
        M.set_strategy("2d")


def _sharded_model(arch, params, mesh):
    """``(blocks, gather)`` of a model's params on ``mesh``: this rank's
    blocks under the rules, and the function that gathers them for the
    model inside ``act_sharding.zero3`` (``train.step.gather_params``),
    with the ``zero3`` arguments."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.step import (block_tree, gather_params,
                                        layer_specs, per_layer_roots)
    spec_tree = shd.infer_param_specs(params, mesh)
    keys, _ = flatten(params)
    specs = shd.spec_leaves(spec_tree)
    roots = per_layer_roots(arch.cfg)
    blocks = block_tree(mesh, params, spec_tree)
    lspecs = layer_specs(arch.cfg, params, spec_tree)
    return blocks, specs, lspecs, lambda b: gather_params(
        b, keys, specs, mesh, roots)


def _forward_case(arch, params, batch, mesh, train):
    """The sharded forward (logits) against the unsharded one; without
    ``train`` also every weight's gradient (the rank's block) of a fixed
    cotangent.  With ``train`` (a sharded train step's compute: bfloat16
    layer weights, sequence-parallel residuals) the unsharded forward
    runs on the layer weights rounded as the step rounds them, and the
    residual carried between layers is recorded."""
    from repro_torch.models import encdec, transformer
    from repro_torch.parallel import act_sharding as act
    from repro_torch.train.step import per_layer_roots
    blocks, specs, lspecs, gather = _sharded_model(arch, params, mesh)
    keys, leaves = flatten(params)
    if train:
        roots = per_layer_roots(arch.cfg)
        params = _unflat(params, [
            x.to(act._cast(k, x)).to(x.dtype)
            if k.split("/")[0] in roots and act._cast(k, x) is not None
            else x for k, x in zip(keys, leaves)])
    fwd = lambda p: arch.forward(p, batch)
    carries = []
    scan = transformer.scan_layers_remat

    def record(body, x, lps, cfg):
        carries.append(tuple(x.shape))
        return scan(body, x, lps, cfg)

    if train:
        with torch.no_grad():
            full = fwd(params)
            transformer.scan_layers_remat = record
            encdec.scan_layers_remat = record
            try:
                with act.zero3(mesh, lspecs, (), train=True):
                    got = fwd(gather(blocks))
            finally:
                transformer.scan_layers_remat = scan
                encdec.scan_layers_remat = scan
        return {"out": (_np(full), _np(got)), "carries": carries}
    from repro_torch.parallel import zero
    full, g_full, _ = _vjp(lambda t: fwd(t), params, ())
    with act.zero3(mesh, lspecs, (), train=False):
        got, g_got, _ = _vjp(lambda b: fwd(gather(b)), blocks, ())
    return {"out": (_np(full), _np(got)),
            "grads": {k: (_np(zero.block(mesh, g, s, k)), _np(h))
                      for k, g, h, s in zip(keys, g_full, g_got, specs)}}


def _serve_case(arch, params, tokens, feed, max_len, mesh):
    """``prefill`` of ``tokens`` then a decode step per column of
    ``feed``, sharded (caches from ``init_cache(mesh=)``, the batch on the
    batch axes) against unsharded: every step's logits and the final
    caches (assembled), and the query heads each attention call saw."""
    from repro_torch.models import attention
    from repro_torch.parallel import act_sharding as act
    from repro_torch.parallel import zero
    from repro_torch.parallel.mesh import batch_axes
    blocks, _, lspecs, gather = _sharded_model(arch, params, mesh)
    rows = (batch_axes(mesh),)
    heads = []
    flash, decode = attention.chunked_attention, attention.decode_attention

    def seen(fn):
        def call(q, *a, **k):
            heads.append(q.shape[2])
            return fn(q, *a, **k)
        return call

    def run(p, blocked):
        cut = (lambda x: mesh.block(x, rows)) if blocked else (lambda x: x)
        whole = (lambda x: zero.assemble(mesh, x, rows)) if blocked \
            else (lambda x: x)
        last, caches = arch.prefill(p, {"tokens": cut(tokens)}, max_len)
        logits = [_np(whole(last))]
        n = tokens.shape[1]
        for t in range(feed.shape[1]):
            out, caches = arch.decode_step(
                p, {"tokens": cut(feed[:, t:t + 1])}, caches, n + t)
            logits.append(_np(whole(out)))
        return logits, caches

    with torch.inference_mode():
        want, c_want = run(params, False)
        attention.chunked_attention = seen(flash)
        attention.decode_attention = seen(decode)
        try:
            with act.zero3(mesh, lspecs, (), train=False):
                got, c_got = run(gather(blocks), True)
        finally:
            attention.chunked_attention = flash
            attention.decode_attention = decode
        caches = {k: (_np(c_want[k].float()),
                      _np(zero.assemble(mesh, c_got[k], c_got[k]._spec)
                          .float()),
                      tuple(c_got[k]._spec))
                  for k in c_want}
    return {"logits": (want, got), "caches": caches,
            "heads": sorted(set(heads))}


def job_tp_models(job):
    """Whole models of ``job["cases"]`` on the mesh ``job["mesh"]``: the
    forward in the serving engine's compute and in a train step's
    (:func:`_forward_case`), and prefill + decode steps
    (:func:`_serve_case`), each sharded against unsharded."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models.registry import make_arch
    mesh = make_mesh(job["mesh"], ("data", "model"), "cpu")
    out = {}
    for name, c in job["cases"].items():
        arch = make_arch(c["cfg"])
        params = _torch_tree(c["params"])
        batch = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
        if c["kind"] == "serve":
            out[name] = _serve_case(arch, params, batch["tokens"],
                                    torch.as_tensor(c["feed"]),
                                    c["max_len"], mesh)
        else:
            out[name] = _forward_case(arch, params, batch, mesh,
                                      c["kind"] == "train")
    return out


def serve_run(eng, vocab: int) -> dict:
    """The reference test's two requests (``arange(5)``, 6 new tokens;
    ``arange(9)``, 4) through ``eng``: their tokens, the (B, V) logits
    every sampling step saw, the collectives of the run and the query
    heads each attention call computed."""
    from repro_torch.core.distributed import count_collectives
    from repro_torch.models import attention
    steps, heads = [], []
    sample, flash = eng._sample, attention.chunked_attention

    def record(logits):
        steps.append(_np(logits[:, -1].float()))
        return sample(logits)

    def seen(q, *a, **k):
        heads.append(q.shape[2])
        return flash(q, *a, **k)

    eng._sample = record
    r1 = eng.submit(np.arange(5) % vocab, max_new_tokens=6)
    r2 = eng.submit(np.arange(9) % vocab, max_new_tokens=4)
    attention.chunked_attention = seen
    try:
        with count_collectives() as c:
            res = eng.run()
    finally:
        attention.chunked_attention = flash
    return {"tokens": [res["results"][r1.rid], res["results"][r2.rid]],
            "steps": steps, "counts": dict(c.counts),
            "heads": sorted(set(heads))}


def _refused(fn):
    """The message of the ValueError ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _unmarked_mlp(mesh):
    """The MLP inside ``zero3`` on ``mesh`` on weights that did not come
    through its gather (their layout unknown)."""
    from repro_torch.models import layers
    from repro_torch.parallel import act_sharding
    w = {"wi_gate": torch.ones(4, 8), "wi_up": torch.ones(4, 8),
         "wo": torch.ones(8, 4)}
    with act_sharding.zero3(mesh, {}, (), train=False):
        layers.mlp(w, torch.ones(1, 2, 4), torch.float32)


def job_serve_mesh(job):
    """``ServeEngine(arch, mesh)`` on the mesh ``job["mesh"]`` for each
    case (its config, and the params it serves or None for its own
    seeded draw), beside the unsharded engine when the case asks: the
    runs of :func:`serve_run`, the shapes of the engine's param blocks,
    and the errors of the layouts it must refuse and of its blocks
    computed on outside ``zero3`` (``outside``) or of weights of unknown
    layout inside it (``unmarked``)."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models.registry import make_arch
    from repro_torch.parallel import mesh as M
    from repro_torch.serve.engine import ServeEngine
    mesh = make_mesh(job["mesh"], ("data", "model"), "cpu")
    out = {}
    for name, c in job["cases"].items():
        arch = make_arch(c["cfg"])
        res = {}
        for which, m in (("mesh", mesh), ("unsharded", None)):
            if which == "unsharded" and not c.get("unsharded"):
                continue
            eng = ServeEngine(arch, m, batch_slots=2, max_len=64,
                              device="cpu", **c.get("kw", {}))
            if c.get("params") is not None:
                eng.load_params(c["params"])
            res[which] = serve_run(eng, c["cfg"].vocab_size)
            if which == "mesh":
                keys, leaves = flatten(eng.params)
                res["blocks"] = {k: tuple(x.shape)
                                 for k, x in zip(keys, leaves)}
                res["outside"] = _refused(lambda: arch.forward(
                    eng.params, {"tokens": torch.zeros(
                        (1, 4), dtype=torch.int32)}))
        out[name] = res
    out["unmarked"] = _refused(lambda: _unmarked_mlp(mesh))
    refusals = {}
    for name, (cfg, kw, strategy) in job.get("refusals", {}).items():
        M.set_strategy(strategy)
        try:
            ServeEngine(make_arch(cfg), mesh, device="cpu", **kw)
        except ValueError as e:
            refusals[name] = str(e)
        finally:
            M.set_strategy("2d")
    out["refusals"] = refusals
    return out


JOBS = {"rollouts": job_rollouts, "steps": job_steps, "env": job_env,
        "restore": job_restore, "card": job_card,
        "collectives": job_collectives, "lm_train": job_lm_train,
        "optim": job_optim, "tp_modules": job_tp_modules,
        "tp_models": job_tp_models, "serve_mesh": job_serve_mesh,
        "vocab_ce": job_vocab_ce, "mamba_layout": job_mamba_layout,
        "lm_step": job_lm_step}


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
