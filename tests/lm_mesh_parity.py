"""Shared helpers of the sharded-training tests
(``tests/test_torch_lm_mesh_*.py``).

The reference's sharded loop (``repro.train.loop.train``) runs in a
subprocess that forces 4 host devices before JAX starts (as
``tests/test_elastic_restore.py`` does) on meshes built with Auto axes:
its default meshes are Explicit under the installed JAX and fail
(ROADMAP queue 3).  The port's ``train(mesh=)`` runs on gloo ranks
(``tests/torch_mesh.py``, ``job_lm_train``) or, for the 1-rank mesh, in
the pytest process; it starts from the reference's initial state, saved
as step 0 of the run's checkpoint directory, and resumes from it.

A run is a dict: ``mesh`` (data, model), ``strategy``, ``arch`` (reduced,
widened by ``cfg``), ``opt`` (name, kwargs), ``lr`` (``warmup_cosine``),
``batch`` (B, S) of ``SyntheticLM`` from seed 0, ``steps``.

Tolerances: logged losses within rtol 1e-5 over
the first 4 steps and within rtol 1e-4 over 10.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_config
from repro.models.registry import make_arch as j_arch
from repro.train import optim as j_optim
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADAMW = dict(arch="qwen1.5-0.5b", opt=("adamw", {"weight_decay": 0.0}),
             lr=(3e-3, 5, 60), batch=(4, 32), steps=10)
#: a widened qwen: vocab and d_ff past the rules' 1024 FSDP floor, so the
#: embedding, the head and the MLP shard over the batch axes
WIDE = {"vocab_size": 2048, "d_ff": 1024}
RTOL_4, RTOL_10 = 1e-5, 1e-4
#: the widened run over 10 steps: its loss (~8) moves with the sum order
#: of its gradients -- the reference's own runs on (1, 1), (2, 2) "dp" and
#: (4, 1) part by up to 6.9e-5 by step 10 (measured), so its 10-step hold
#: is 2e-4; its first 4 steps keep 1e-5
RTOL_10_WIDE = 2e-4
#: the reference's own 10-step runs of reduced yi-6b part by up to 1.19e-4
#: between meshes ((2, 2) against (1, 1)) and of reduced
#: granite-moe-1b-a400m by up to 1.75e-3 ((1, 2) against (1, 1): its top-2
#: routing meets near ties) -- measured -- so their tensor-parallel runs
#: are held over 10 steps within these; their first 4 steps keep 1e-5
RTOL_10_GQA, RTOL_10_MOE = 2e-4, 2e-3

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import dataclasses
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.registry import make_arch
from repro.parallel import mesh as M
from repro.train import optim
from repro.train.data import SyntheticLM
from repro.train.loop import train
out = []
for run in json.loads(sys.argv[1]):
    M.set_strategy(run.get("strategy", "2d"))
    cfg = dataclasses.replace(get_config(run["arch"], reduced=True),
                              **run.get("cfg", {}))
    name, kw = run["opt"]
    opt = optim.OPTIMIZERS[name](optim.warmup_cosine(*run["lr"]), **kw)
    mesh = jax.make_mesh(tuple(run["mesh"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    b, s = run["batch"]
    _, hist = train(make_arch(cfg), opt, mesh,
                    SyntheticLM(cfg.vocab_size, b, s, seed=0),
                    steps=run["steps"], log_every=1)
    out.append(hist)
print("REF_JSON " + json.dumps(out))
"""


def reference_losses(runs) -> list:
    """The reference's logged losses (every step) of each run."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, json.dumps(runs)],
                       env=env, capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    lines = [l for l in r.stdout.splitlines() if l.startswith("REF_JSON ")]
    assert r.returncode == 0 and lines, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(lines[-1].removeprefix("REF_JSON "))


def reference_init(run) -> dict:
    """The reference's initial train state of a run (numpy leaves): its
    ``init_state``'s values, drawn unsharded."""
    cfg = dataclasses.replace(j_config(run["arch"], reduced=True),
                              **run.get("cfg", {}))
    name, kw = run["opt"]
    opt = j_optim.OPTIMIZERS[name](j_optim.warmup_cosine(*run["lr"]), **kw)
    params = j_arch(cfg).init(jax.random.PRNGKey(0))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    return jax.tree_util.tree_map(np.asarray, state)


def start_from_reference(run, d) -> dict:
    """Write the reference's initial state of ``run`` as step 0 under
    ``d``; returns the run with ``dir`` set."""
    cfg = dataclasses.replace(get_config(run["arch"], reduced=True),
                              **run.get("cfg", {}))
    ckpt.save(str(d), 0, convert.train_state(reference_init(run), cfg,
                                             "cpu"),
              extra={"train_step": 0})
    return dict(run, dir=str(d))


def hold(got, want, what, rtol_all=RTOL_10):
    """Losses within rtol 1e-5 over the first 4 steps, ``rtol_all`` (1e-4)
    over all."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got, want)
    np.testing.assert_allclose(got[:4], want[:4], rtol=RTOL_4,
                               err_msg=f"{what}: first 4 steps")
    np.testing.assert_allclose(got, want, rtol=rtol_all,
                               err_msg=f"{what}: all steps")


# ------------------------------------------------ step-1 gradients
#: the reference's step-1 gradient (before clipping) of a run on Auto
#: meshes of each shape, from its ``init_state``, written to an npz
REF_GRADS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import dataclasses
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.registry import make_arch
from repro.train import optim
from repro.train.data import SyntheticLM
from repro.train.step import init_state, jit_train_step, make_loss_fn
run, path = json.loads(sys.argv[1]), sys.argv[2]
cfg = dataclasses.replace(get_config(run["arch"], reduced=True),
                          **run.get("cfg", {}))
arch = make_arch(cfg)
name, kw = run["opt"]
opt = optim.OPTIMIZERS[name](optim.warmup_cosine(*run["lr"]), **kw)
b, s = run["batch"]
batch = SyntheticLM(cfg.vocab_size, b, s, seed=0).batch_at(0)
shapes = jax.tree_util.tree_map(
    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch)
loss_fn = make_loss_fn(arch)
out = {}
for shape in run["meshes"]:
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    _, _, state_sh, batch_sh = jit_train_step(arch, opt, mesh, shapes)
    state = init_state(arch, opt, mesh, 0)
    grad = jax.jit(lambda p, x: jax.grad(loss_fn, has_aux=True)(p, x)[0],
                   in_shardings=(state_sh["params"], batch_sh))
    g = grad(state["params"], batch)
    for kp, x in jax.tree_util.tree_flatten_with_path(g)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in kp)
        out[f"{shape[0]}x{shape[1]}:{key}"] = np.asarray(x, np.float32)
np.savez(path, **out)
"""


#: each leaf's norm of the port's step-1 gradient against the reference's
#: on the same mesh (reduced falcon-mamba-7b and zamba2-1.2b in float32):
#: the reference's own (1, 2) and (2, 2) gradients part from its (1, 1)
#: by up to 5.4e-06 in a leaf's norm there, the port's from the
#: reference's by up to 3.8e-06 (measured); a gradient summed twice over
#: ``model``, or not summed, moves a leaf's norm by 0.29 or more
GRAD_NORM_RTOL = 1e-4


def hold_grads(got, want, what, rtol=GRAD_NORM_RTOL):
    """Every leaf of ``want`` in ``got``, its norm within ``rtol``."""
    assert sorted(got) == sorted(want), what
    gaps = {k: abs(float(np.linalg.norm(got[k]))
                   / float(np.linalg.norm(want[k])) - 1) for k in want}
    bad = {k: v for k, v in gaps.items() if not v <= rtol}
    assert not bad, f"{what}: leaf norms past rtol {rtol}: {bad}"


def reference_grads(run, meshes, d) -> dict:
    """``{mesh: {key: gradient}}``: the reference's step-1 gradient of
    ``run`` (its loss, before clipping) on Auto meshes of each shape,
    from its ``init_state`` (``d``: a scratch directory)."""
    path = os.path.join(d, "ref_grads.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_GRADS,
                        json.dumps(dict(run, meshes=meshes)), str(path)],
                       env=env, capture_output=True, text=True,
                       timeout=1800, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = {tuple(m): {} for m in meshes}
    with np.load(path) as z:
        for name in z.files:
            m, key = name.split(":")
            out[tuple(map(int, m.split("x")))][key] = z[name]
    return out


def port_grads(run, meshes, d) -> dict:
    """``{mesh: {key: gradient}}``: the port's step-1 gradient of ``run``
    (``train.step``'s sharded step, gloo ranks, job ``lm_step``) on each
    mesh, from the reference's initial state (``d``: a scratch
    directory)."""
    import torch
    import torch_mesh
    cfg = dataclasses.replace(get_config(run["arch"], reduced=True),
                              **run.get("cfg", {}))
    init = os.path.join(d, "init.pt")
    torch.save(convert.train_state(reference_init(run), cfg, "cpu"), init)
    return {m: torch_mesh.run_ranks({"name": "lm_step", "runs": [dict(
        run, mesh=m, steps=1, grads=True, init=init)]},
        m[0] * m[1], d)[0][0]["grads"] for m in meshes}


# ------------------------------------------------ tensor-parallel parity
#: float32 contract of the tensor-parallel tests: within rtol 1e-5 of each
#: tensor's largest magnitude (the psums change the sum order)
TP_RTOL = 1e-5
TP_MESHES = [(1, 2), (2, 2)]


def tp_close(got, want, what, rtol=TP_RTOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def tp_run(job, cases, tmp_path_factory, meshes=None) -> dict:
    """``{mesh shape: every rank's output}`` of the ``tests/torch_mesh.py``
    job ``job`` over ``cases`` on each of ``meshes`` (default
    :data:`TP_MESHES`)."""
    import torch_mesh
    out = {}
    for shape in meshes or TP_MESHES:
        out[shape] = torch_mesh.run_ranks(
            {"name": job, "mesh": shape, "cases": cases},
            shape[0] * shape[1], tmp_path_factory.mktemp(job))
    return out


def tp_cases(table, extra) -> dict:
    """The cases of ``table`` (name -> (arch, config overrides, kind)) on
    the reference's params of each reduced config (its ``init`` under
    ``jax.jit``, as its serving engine draws them), with the inputs
    ``extra(cfg, kind, rng)`` adds."""
    import lm_parity as lp
    rng = np.random.default_rng(5)
    pairs, out = {}, {}
    for name, (arch, over, kind) in table.items():
        key = (arch, tuple(sorted(over.items())))
        if key not in pairs:
            jcfg = dataclasses.replace(j_config(arch, reduced=True), **over)
            tcfg = lp.port_config(jcfg)
            tree = jax.jit(j_arch(jcfg).init)(jax.random.PRNGKey(0))
            pairs[key] = (tcfg, convert.lm_params(lp.np_tree(tree), tcfg,
                                                  "cpu"))
        cfg, params = pairs[key]
        out[name] = dict({"cfg": cfg, "params": params, "kind": kind},
                         **extra(cfg, kind, rng))
    return out


# ------------------------------------------------- serving on a mesh
SERVE_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P
from repro.analysis.hlo import collective_stats
from repro.configs import get_config
from repro.models.registry import make_arch
from repro.serve.engine import ServeEngine
archs, meshes, d = json.loads(sys.argv[1])
out = {}
for arch_id in archs:
    for shape in meshes:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        arch = make_arch(get_config(arch_id, reduced=True))
        eng = ServeEngine(arch, mesh, batch_slots=2, max_len=64)
        steps = []

        def prefill(p, b, max_len, arch=arch, eng=eng):
            last, caches = arch.prefill(p, b, max_len)
            steps.append(np.asarray(last[:, -1], np.float32).tolist())
            # the engine's eager prefill lays a sequence-sharded cache out
            # otherwise than its jitted decode takes it: reshard (exact)
            return last, jax.device_put(caches, eng.cache_sh)

        decode = eng._decode

        def recorded(*a, decode=decode):
            logits, caches = decode(*a)
            steps.append(np.asarray(logits[:, -1], np.float32).tolist())
            return logits, caches

        eng.arch = dataclasses.replace(arch, prefill=prefill)
        eng._decode = recorded
        V = arch.cfg.vocab_size
        r1 = eng.submit(np.arange(5) % V, 6)
        r2 = eng.submit(np.arange(9) % V, 4)
        res = eng.run()
        key = f"{arch_id}@{shape[0]}x{shape[1]}"
        flat = jax.tree_util.tree_flatten_with_path(eng.params)[0]
        np.savez(os.path.join(d, key + ".npz"), **{
            "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in flat})
        out[key] = {"tokens": [res["results"][r1.rid],
                               res["results"][r2.rid]], "steps": steps}
# an HLO module with collectives over 4 devices inside a scan
hmesh = jax.make_mesh((4,), ("x",), axis_types=(AxisType.Auto,))
smap = getattr(jax, "shard_map", None)
if smap is None:
    from jax.experimental.shard_map import shard_map as smap
psum = smap(lambda v: jax.lax.psum(v, "x"), mesh=hmesh, in_specs=P("x"),
            out_specs=P())
scatter = smap(lambda v: jax.lax.psum_scatter(v, "x", tiled=True),
               mesh=hmesh, in_specs=P(), out_specs=P("x"))

def f(x):
    def body(c, _):
        return c + psum(c).sum() + scatter(c)[:1].sum(), None
    return jax.lax.scan(body, x, None, length=3)[0]

x = jax.device_put(jnp.arange(16.0), NamedSharding(hmesh, P("x")))
text = jax.jit(f).lower(x).compile().as_text()
with open(os.path.join(d, "module.hlo"), "w") as fh:
    fh.write(text)
st = collective_stats(text)
out["hlo"] = {"counts": st.counts, "bytes_by_kind": st.bytes_by_kind,
              "total_wire_bytes": st.total_wire_bytes}
print("REF_JSON " + json.dumps(out))
"""


def reference_serving(archs, meshes, d) -> dict:
    """The reference's ``ServeEngine`` on Auto meshes of each shape for
    each reduced arch, in one subprocess forcing 4 host devices: the
    reference test's two requests' tokens and every step's (B, V)
    logits, keyed ``"arch@DxM"``; its params under ``d`` (``.npz``, key
    paths); and an HLO module's text (``d/module.hlo``) with the
    reference's ``collective_stats`` of it (``"hlo"``)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", SERVE_SCRIPT,
                        json.dumps([list(archs), [list(m) for m in meshes],
                                    str(d)])],
                       env=env, capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    lines = [l for l in r.stdout.splitlines() if l.startswith("REF_JSON ")]
    assert r.returncode == 0 and lines, r.stdout[-3000:] + r.stderr[-3000:]
    return json.loads(lines[-1].removeprefix("REF_JSON "))


def reference_params(d, key, cfg) -> dict:
    """The port's params of the reference engine's params saved by
    :func:`reference_serving` under ``key``."""
    tree = {}
    with np.load(os.path.join(str(d), key + ".npz")) as z:
        for path in z.files:
            node = tree
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[path]
    return convert.lm_params(tree, cfg, "cpu")


SERVE_MESHES = [(1, 1), (1, 2)]


def serve_key(arch, shape) -> str:
    return f"{arch}@{shape[0]}x{shape[1]}"


def serve_on_meshes(archs, tmp_path_factory) -> tuple:
    """``(reference, d, port)``: :func:`reference_serving` of ``archs`` on
    :data:`SERVE_MESHES` (its files under ``d``), and the port's
    ``ServeEngine(arch, mesh)`` on the same meshes serving the reference
    engine's own params (``tests/torch_mesh.py``, job ``serve_mesh``):
    (1, 1) on a 1-rank gloo group in this process, (1, 2) on two gloo
    ranks; ``port[shape]`` holds every rank's output."""
    import torch_mesh
    from repro_torch.configs import get_config
    d = tmp_path_factory.mktemp("ref")
    ref = reference_serving(archs, SERVE_MESHES, d)
    port = {}
    for shape in SERVE_MESHES:
        cases = {}
        for arch in archs:
            cfg = get_config(arch, reduced=True)
            cases[arch] = {"cfg": cfg, "params": reference_params(
                d, serve_key(arch, shape), cfg)}
        job = {"name": "serve_mesh", "mesh": shape, "cases": cases}
        if shape == (1, 1):
            with torch_mesh.one_rank_group(tmp_path_factory.mktemp("one")):
                port[shape] = [torch_mesh.JOBS["serve_mesh"](job)]
        else:
            port[shape] = torch_mesh.run_ranks(
                job, 2, tmp_path_factory.mktemp("ranks"))
    return ref, d, port


def hold_served(ref, port, arch, shape):
    """The port's engine on ``shape`` against the reference's, on every
    rank, under ``tests/lm_fixture.py``'s contract: logits within 1e-3
    while a slot's inputs agree, tokens exact off counted near ties."""
    import lm_fixture as lf
    from repro_torch.configs import get_config
    want = ref[serve_key(arch, shape)]
    probe = lf.probe_ids(get_config(arch, reduced=True))
    w = lf.summarize([np.asarray(s, np.float32) for s in want["steps"]],
                     probe)
    for rank, out in enumerate(port[shape]):
        got = out[arch]["mesh"]
        res = lf.hold(lf.summarize(got["steps"], probe), w, got["tokens"],
                      want["tokens"], "float32")
        assert res["held_steps"] == 12, (rank, res)
        assert len(got["tokens"][0]) == 6 and len(got["tokens"][1]) == 4


def hold_blocks(port, arch):
    """On (1, 2) each rank holds half of the heads, KV heads (or yi's
    head_dim), F columns, experts and vocab rows / columns -- one dimension
    of a leaf at most -- and its attention computes 2 of the 4 heads."""
    one, two = port[(1, 1)][0][arch], port[(1, 2)]
    for out in two:
        blocks = out[arch]["blocks"]
        for k, shape in one["blocks"].items():
            halved = [i for i, (a, b) in enumerate(zip(shape, blocks[k]))
                      if a != b]
            assert all(shape[i] == 2 * blocks[k][i] for i in halved), k
            assert len(halved) <= 1, k
        assert blocks["layers/attn/wq"] == (2, 128, 2, 32)
        assert blocks["layers/attn/wo"] == (2, 2, 32, 128)
        assert blocks["embed/embedding"] == (256, 128)
        assert blocks["lm_head/kernel"] == (128, 256)
        assert out[arch]["mesh"]["heads"] == [2]
    assert one["mesh"]["heads"] == [4]
    assert one["mesh"]["counts"] == {}
    assert two[0][arch]["mesh"]["counts"]["all-reduce"] > 0
    return two[0][arch]["blocks"]


def hold_channel_blocks(port, arch):
    """On (1, 2) each rank holds half of a Mamba layer's channels: its
    ``in_proj`` columns, ``out_proj`` rows and conv channels; (1, 1) makes
    no collective, (1, 2) some."""
    whole = port[(1, 1)][0][arch]["blocks"]
    assert port[(1, 1)][0][arch]["mesh"]["counts"] == {}
    for out in port[(1, 2)]:
        blocks = out[arch]["blocks"]
        for key, dim in (("in_proj", 2), ("out_proj", 1), ("conv_w", 1)):
            w, b = whole[f"layers/ssm/{key}"], blocks[f"layers/ssm/{key}"]
            assert b[dim] * 2 == w[dim] and b[:dim] == w[:dim], (key, b, w)
        assert out[arch]["mesh"]["counts"]["all-reduce"] > 0
