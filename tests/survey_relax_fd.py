"""Where the relaxed engine's finite-difference contract holds, in both
packages (the JAX package and the port, on the CPU).

1. ``tests/test_rl.py:47``'s check (12 UEs x 8 TTIs, best relative error
   over its four eps) on seeds 0-5 of each scenario's drop: the reference
   on ``PRNGKey(seed)``, the port on its own ``Draws(seed)``.
2. The power objective over ``optimize_power_plan``'s defaults at
   ``dense_urban``'s 200 UEs (``tests/data/relax_diffopt_dense_urban.npz``):
   value, g.v and FD errors of the port, the compiled reference and the
   eager reference (``jax.disable_jit``, ~2 min).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/survey_relax_fd.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import relax_fixture
from repro.core.crrm import CRRM
from repro.env.crrm_env import expand_action
from repro.rl import diffopt
from repro.sim.radio import RelaxConfig as JRelax
from repro.sim.scenarios import make_scenario
from repro_torch.mac.engine import Draws
from repro_torch.sim.radio import RelaxConfig
from torch_parity import np_, pair

EPS = relax_fixture.EPS


def best_err(f, x0, v, gv):
    fds = [float(f(x0 + e * v) - f(x0 - e * v)) / (2 * e) for e in EPS]
    return min(abs(gv - fd) / max(abs(fd), 1e-12) for fd in fds)


def seeds(scenario, n_seeds=6):
    ref, port = pair(make_scenario(scenario, n_ues=relax_fixture.N_UES))
    p = ref.params
    P0 = expand_action(p, jnp.full((ref.n_cells, p.n_subbands),
                                   p.power_W / p.n_subbands, jnp.float32))
    v = jax.random.normal(jax.random.PRNGKey(1), P0.shape, jnp.float32)
    v = v / jnp.linalg.norm(v) * jnp.linalg.norm(P0)
    fns_j = ref.episode_fns(radio_mode="dense", relax=JRelax())
    fns_t = port.episode_fns(radio_mode="dense", relax=RelaxConfig())
    static_j, static_t = ref.episode_static(), port.episode_static()
    P_t, v_t = torch.tensor(np_(P0)), torch.tensor(np_(v))
    n = relax_fixture.N_TTI
    for seed in range(n_seeds):
        s_j = ref.init_episode_state(jax.random.PRNGKey(seed))
        f_j = jax.jit(lambda P: fns_j.rollout(static_j, s_j, n, P)[1]
                      .mean() / 1e6)
        e_j = best_err(f_j, P0, v, float(jnp.sum(jax.grad(f_j)(P0) * v)))
        s_t = port.init_episode_state(seed)

        def f_t(P):
            return fns_t.rollout(static_t, s_t, n, Draws(seed, "cpu"),
                                 P)[1].mean() / 1e6

        leaf = P_t.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(f_t(leaf), leaf)
        with torch.no_grad():
            e_t = best_err(f_t, P_t, v_t, float((g * v_t).sum()))
        print(f"{scenario} seed {seed}: reference {e_j:.3g}, port {e_t:.3g}",
              flush=True)


def width():
    d = relax_fixture.DIFFOPT
    n_seg, tti = relax_fixture.HORIZONS["full"]
    out = relax_fixture.diffopt_check(torch.device("cpu"), "full")
    rows = [("port", out["port"]), ("reference, compiled", out["ref"])]
    ref = CRRM(make_scenario(d["scenario"], n_ues=d["n_ues"]))
    v = jnp.asarray(relax_fixture.read(d["scenario"], "diffopt")
                    ["full_direction"])
    u0 = jnp.zeros(v.shape, jnp.float32)
    with jax.disable_jit():
        soft, _ = diffopt.make_power_objective(ref, tti_per_segment=tti)
        value, g = jax.value_and_grad(soft)(u0)
        gv = float(jnp.sum(g * v))
        fds = [float(soft(u0 + e * v) - soft(u0 - e * v)) / (2 * e)
               for e in EPS]
    rows.append(("reference, eager", dict(
        value=float(value), gv=gv,
        fd_errs=[abs(gv - fd) / max(abs(fd), 1e-12) for fd in fds])))
    for name, r in rows:
        print(f"{d['n_ues']} UEs x {n_seg * tti} TTIs, {name}: value "
              f"{r['value']:.7g}, g.v {r['gv']:.6g}, FD rel err per eps "
              + ", ".join(f"{e:.3g}" for e in r["fd_errs"]), flush=True)


if __name__ == "__main__":
    for name in relax_fixture.SCENARIOS:
        seeds(name)
    width()
