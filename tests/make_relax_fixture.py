"""Write ``tests/data/relax_*.npz`` from the JAX package (the reference).

The inputs of the reference's relaxed-engine gradient checks, and for the
``diffopt`` check the reference's own value, ``jax.grad`` and central
differences, as ``tests/relax_fixture.py`` reads them:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_relax_fixture.py

``tests/test_torch_relax_grad.py`` holds the committed files equal to
what :func:`build` and :func:`build_diffopt` return.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from relax_fixture import (DATA, DIFFOPT, EPS, HORIZONS, N_TTI, N_UES,
                           ROOTS, SCENARIOS, path)
from repro.core.crrm import CRRM
from repro.rl import diffopt
from repro.sim import radio
from repro.sim.scenarios import make_scenario


def inputs(ref, key, n_tti: int) -> dict:
    """The drop's roots, the episode's static and initial state on
    ``key``, and that key's traffic and HARQ draws of ``n_tti`` TTIs."""
    out = {f"root_{k}": np.asarray(getattr(ref, k)._data) for k in ROOTS}
    for prefix, nt in (("static", ref.episode_static()),
                       ("state", ref.init_episode_state(key))):
        for k, v in nt._asdict().items():
            if v is not None and k != "key":
                out[f"{prefix}_{k}"] = np.asarray(v)
    arrivals, harq = [], []
    for t in range(n_tti):
        k = radio.tti_keys(key, t)
        arrivals.append(np.asarray(ref._traffic_step(k[2], t)))
        harq.append(np.asarray(jax.random.uniform(k[3], (ref.n_ues,))))
    out["arrivals"], out["harq_u"] = np.stack(arrivals), np.stack(harq)
    return out


def build(scenario: str) -> dict:
    """The inputs of ``tests/test_rl.py``'s FD check on ``scenario``."""
    ref = CRRM(make_scenario(scenario, n_ues=N_UES))
    out = inputs(ref, jax.random.PRNGKey(0), N_TTI)
    out["direction"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), out["static_P"].shape, jnp.float32))
    return out


def build_diffopt() -> dict:
    """``make_power_objective``'s soft objective at ``u = 0`` on the
    preset width: the inputs of the longest horizon, and per horizon a
    unit direction of ``PRNGKey(1)`` and the reference's value, gradient,
    derivative along the direction and central-difference errors per
    eps."""
    ref = CRRM(make_scenario(DIFFOPT["scenario"], n_ues=DIFFOPT["n_ues"]))
    out = inputs(ref, jax.random.PRNGKey(0),
                 max(n * t for n, t in HORIZONS.values()))
    for name, (n_seg, tti) in HORIZONS.items():
        soft, _ = diffopt.make_power_objective(ref, tti_per_segment=tti)
        u0 = jnp.zeros((n_seg, ref.n_cells, ref.params.n_subbands),
                       jnp.float32)
        v = jax.random.normal(jax.random.PRNGKey(1), u0.shape, jnp.float32)
        v = v / jnp.linalg.norm(v)
        value, g = jax.value_and_grad(soft)(u0)
        gv = float(jnp.sum(g * v))
        errs = []
        for eps in EPS:
            fd = float(soft(u0 + eps * v) - soft(u0 - eps * v)) / (2 * eps)
            errs.append(abs(gv - fd) / max(abs(fd), 1e-12))
        out.update({f"{name}_direction": np.asarray(v),
                    f"{name}_ref_value": np.float32(value),
                    f"{name}_ref_grad": np.asarray(g),
                    f"{name}_ref_gv": np.float64(gv),
                    f"{name}_ref_fd_errs": np.asarray(errs)})
    return out


if __name__ == "__main__":
    DATA.mkdir(exist_ok=True)
    for name in SCENARIOS:
        np.savez_compressed(path(name), **build(name))
        print(path(name))
    np.savez_compressed(path(DIFFOPT["scenario"], "diffopt"),
                        **build_diffopt())
    print(path(DIFFOPT["scenario"], "diffopt"))
