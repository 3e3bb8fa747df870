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
